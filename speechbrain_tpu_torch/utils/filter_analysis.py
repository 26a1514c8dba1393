"""Receptive field and stride of cascaded filters (port of
``speechbrain_tpu/utils/filter_analysis.py``), used to map a streaming
chunk to the samples and frames it covers.

Example
-------
>>> stft = FilterProperties(window_size=400, stride=160)
>>> stack_filter_properties([stft, FilterProperties(3, 2)])
FilterProperties(window_size=720, stride=320, dilation=1, causal=False)
"""

from dataclasses import dataclass


@dataclass
class FilterProperties:
    """Window size, stride, dilation and causality of a filter, or of a
    cascade of filters."""

    window_size: int
    stride: int = 1
    dilation: int = 1
    causal: bool = False

    @staticmethod
    def pointwise_filter():
        return FilterProperties(window_size=1, stride=1)

    def with_on_top(self, other, allow_approximate=True):
        """The properties of ``other`` applied after ``self``."""
        self_size = self.get_effective_size()
        other_size = other.get_effective_size()
        if other.dilation != 1 and self.stride != 1 and not allow_approximate:
            raise ValueError(
                "Cannot exactly model dilation on top of a strided filter"
            )
        size = self_size + (other_size - 1) * self.stride
        stride = self.stride * other.stride
        causal = self.causal and other.causal
        return FilterProperties(size, stride, causal=causal)

    def get_effective_size(self):
        return 1 + (self.window_size - 1) * self.dilation

    def get_convolution_padding(self):
        """The padding (left, right) that keeps the output's length."""
        if self.window_size % 2 == 0:
            raise ValueError("Cannot determine padding for even window sizes")
        if self.causal:
            return (self.get_effective_size() - 1, 0)
        half = (self.get_effective_size() - 1) // 2
        return (half, half)

    def get_noncausal_equivalent(self):
        if not self.causal:
            return self
        return FilterProperties(
            window_size=self.window_size * 2 - 1, stride=self.stride,
            dilation=self.dilation, causal=False,
        )


def stack_filter_properties(filters, allow_approximate=True):
    """The properties of a sequence of filters applied in order, earliest
    first; an item with ``get_filter_properties()`` gives its own."""
    filters = [
        f.get_filter_properties() if hasattr(f, "get_filter_properties") else f
        for f in filters
    ]
    if not filters:
        return FilterProperties.pointwise_filter()
    out = filters[0]
    for f in filters[1:]:
        out = out.with_on_top(f, allow_approximate)
    return out
