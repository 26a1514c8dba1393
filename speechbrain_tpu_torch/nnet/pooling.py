"""Pooling layers (port of ``Pooling1d`` and ``Pooling2d`` from
``speechbrain_tpu/nnet/pooling.py``; its statistics, adaptive, Gaussian
and attention pooling come with the speaker family).

Windows are VALID after the explicit padding: a remainder shorter than the
window is dropped (floor mode). Max pooling pads with -inf, average
pooling with zeros that count in the mean (the JAX package divides each
window's sum by the window's size).
"""

import torch.nn as nn
import torch.nn.functional as F


def _pool(x, pool_type, kernel, stride, padding):
    """``x`` channels-first ``(N, C, *spatial)``."""
    if pool_type == "max":
        pool = F.max_pool1d if len(kernel) == 1 else F.max_pool2d
        return pool(x, kernel, stride, padding)
    if pool_type == "avg":
        pool = F.avg_pool1d if len(kernel) == 1 else F.avg_pool2d
        return pool(x, kernel, stride, padding, count_include_pad=True)
    raise ValueError(f"Unknown pool_type {pool_type}")


class Pooling1d(nn.Module):
    """Max or average pooling over time of ``(batch, time, channel)``.

    Example
    -------
    >>> import torch
    >>> pool = Pooling1d("max", 3)
    >>> pool(torch.ones(10, 30, 40)).shape
    torch.Size([10, 10, 40])
    """

    def __init__(self, pool_type="max", kernel_size=1, stride=None,
                 padding=0, ceil_mode=False):
        super().__init__()
        if ceil_mode:
            raise ValueError("ceil_mode is not supported (floor mode only)")
        self.pool_type = pool_type
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x):
        y = _pool(x.transpose(1, 2), self.pool_type, (self.kernel_size,),
                  (self.stride,), self.padding)
        return y.transpose(1, 2)


class Pooling2d(nn.Module):
    """Max or average pooling over (time, feature) of ``(batch, time,
    feature[, channel])``.

    Example
    -------
    >>> import torch
    >>> pool = Pooling2d("max", (1, 2))
    >>> pool(torch.ones(2, 10, 40, 8)).shape
    torch.Size([2, 10, 20, 8])
    """

    def __init__(self, pool_type="max", kernel_size=(1, 1), stride=None,
                 padding=0):
        super().__init__()
        self.pool_type = pool_type
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride or kernel_size)
        self.padding = padding

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[..., None]
        y = _pool(x.permute(0, 3, 1, 2), self.pool_type, self.kernel_size,
                  self.stride, self.padding).permute(0, 2, 3, 1)
        return y[..., 0] if squeeze else y
