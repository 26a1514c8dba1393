"""Convolutional layers on (batch, time, [height,] channel) layouts
(port of ``speechbrain_tpu/nnet/CNN.py``: ``Conv1d`` and ``Conv2d``).

The public surface keeps the JAX package's channels-last layouts (NWC /
NHWC); inside, tensors are moved to PyTorch's channels-first layout for
``F.conv1d`` / ``F.conv2d``. Weights are stored ``(out, in/groups, k)``
and ``(out, in/groups, kh, kw)``.

Padding semantics: "same" keeps L_out = ceil(L/stride), "causal"
left-pads by (K-1)*dilation, "valid" pads nothing.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.linear import lecun_normal_

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "circular": "circular"}


def _same_pad_1d(L, kernel, stride, dilation):
    """'same' padding amounts: symmetric floor((L_in - L_out)/2) for
    stride 1, floor(kernel/2) each side (dilation ignored) for
    stride > 1."""
    if stride > 1:
        p = kernel // 2
        return p, p
    L_out = (L - dilation * (kernel - 1) - 1) // stride + 1
    p = (L - L_out) // 2
    return p, p


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv1d(nn.Module):
    """1-D convolution on (batch, time, channel).

    Example
    -------
    >>> conv = Conv1d(out_channels=25, kernel_size=11, in_channels=16,
    ...               device="cpu")
    >>> conv(torch.ones(10, 40, 16)).shape
    torch.Size([10, 40, 25])
    """

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding="same", groups=1, bias=True,
                 padding_mode="reflect", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.padding = padding
        self.groups = groups
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size,
            device=device, dtype=dtype,
        ))
        lecun_normal_(
            self.weight, (in_channels // groups) * kernel_size, generator
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_channels, device=device, dtype=dtype))
            if bias else None
        )

    def forward(self, x):
        unsqueezed = x.ndim == 2
        if unsqueezed:
            x = x[..., None]
        if self.padding == "same":
            pads = _same_pad_1d(
                x.shape[1], self.kernel_size, self.stride, self.dilation
            )
        elif self.padding == "causal":
            pads = ((self.kernel_size - 1) * self.dilation, 0)
        elif self.padding == "valid":
            pads = (0, 0)
        elif isinstance(self.padding, int):
            pads = (self.padding, self.padding)
        else:
            raise ValueError(f"Unsupported padding {self.padding}")
        x = x.transpose(1, 2)  # (B, C, T)
        # padding_mode applies to 'same' padding only; reflect needs
        # pad < axis length, degenerate short axes are zero-padded
        if (
            self.padding == "same"
            and self.padding_mode != "constant"
            and pads != (0, 0)
            and max(pads) < x.shape[2]
        ):
            x = F.pad(x, pads, mode=_PAD_MODES[self.padding_mode])
        elif pads != (0, 0):
            x = F.pad(x, pads)
        y = F.conv1d(
            x, self.weight, self.bias, stride=self.stride,
            dilation=self.dilation, groups=self.groups,
        ).transpose(1, 2)
        if unsqueezed and self.out_channels == 1:
            y = y[..., 0]
        return y


class Conv2d(nn.Module):
    """2-D convolution on (batch, time, feature, channel) — NHWC.

    Example
    -------
    >>> conv = Conv2d(out_channels=8, kernel_size=(3, 3), in_channels=1,
    ...               device="cpu")
    >>> conv(torch.ones(10, 40, 16, 1)).shape
    torch.Size([10, 40, 16, 8])
    """

    def __init__(self, out_channels, in_channels, kernel_size=(3, 3),
                 stride=(1, 1), dilation=(1, 1), padding="same", groups=1,
                 bias=True, padding_mode="reflect", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.padding = padding
        self.groups = groups
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size,
            device=device, dtype=dtype,
        ))
        fan_in = (
            (in_channels // groups) * self.kernel_size[0]
            * self.kernel_size[1]
        )
        lecun_normal_(self.weight, fan_in, generator)
        self.bias = (
            nn.Parameter(torch.zeros(out_channels, device=device, dtype=dtype))
            if bias else None
        )

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]
        ks, st, dl = self.kernel_size, self.stride, self.dilation
        p_same_f = _same_pad_1d(x.shape[2], ks[1], st[1], dl[1])
        if self.padding == "same":
            pads = (_same_pad_1d(x.shape[1], ks[0], st[0], dl[0]), p_same_f)
        elif self.padding == "causal":
            pads = (((ks[0] - 1) * dl[0], 0), p_same_f)
        elif self.padding == "valid":
            pads = ((0, 0), (0, 0))
        else:
            raise ValueError(f"Unsupported padding {self.padding}")
        T, Fdim = x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)  # (B, C, T, F)
        flat = (pads[1][0], pads[1][1], pads[0][0], pads[0][1])
        if (
            self.padding == "same"
            and self.padding_mode != "constant"
            and any(flat)
            and max(pads[0]) < T
            and max(pads[1]) < Fdim
        ):
            x = F.pad(x, flat, mode=_PAD_MODES[self.padding_mode])
        elif any(flat):
            x = F.pad(x, flat)
        y = F.conv2d(
            x, self.weight, self.bias, stride=st, dilation=dl,
            groups=self.groups,
        )
        return y.permute(0, 2, 3, 1)
