"""Convolutional layers on (batch, time, [height,] channel) layouts
(port of ``speechbrain_tpu/nnet/CNN.py``: ``SincConv``, ``Conv1d``,
``Conv2d``, ``ConvTranspose1d`` and ``GaborConv1d``).

The public surface keeps the JAX package's channels-last layouts (NWC /
NHWC); inside, tensors are moved to PyTorch's channels-first layout for
``F.conv1d`` / ``F.conv2d``. Weights are stored ``(out, in/groups, k)``
and ``(out, in/groups, kh, kw)``; the transposed convolution's
``(in, out/groups, k)``, as ``torch.nn.ConvTranspose1d`` stores it.

Padding semantics: "same" keeps L_out = ceil(L/stride), "causal"
left-pads by (K-1)*dilation, "valid" pads nothing, an integer n pads n
zeros on every side.
"""

import math

import numpy as np
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


class SincConv(nn.Module):
    """SincNet's band-pass filters on (batch, time[, 1]) waveforms ->
    (batch, time', out_channels): filter ``c`` passes from ``min_low_hz +
    |low_hz[c]|`` to that plus ``min_band_hz + |band_hz[c]|`` (clipped to
    ``[min_low_hz, sample_rate / 2]``), a windowed sinc of odd
    ``kernel_size`` taps rebuilt from the two learned cut-offs every call,
    so that gradients reach them. The cut-offs start evenly spaced on the
    mel scale from 30 Hz. Zero ``"same"`` padding or none (``"valid"``).

    Example
    -------
    >>> conv = SincConv(out_channels=8, kernel_size=65, device="cpu")
    >>> conv(torch.ones(4, 16000, 1)).shape
    torch.Size([4, 16000, 8])
    """

    def __init__(self, out_channels, kernel_size, stride=1, dilation=1,
                 padding="same", sample_rate=16000, min_low_hz=50.0,
                 min_band_hz=50.0, device="cuda", dtype=torch.float32):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("SincConv kernel size must be odd")
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.padding = padding
        self.sample_rate = sample_rate
        self.min_low_hz = min_low_hz
        self.min_band_hz = min_band_hz
        high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)
        mel = np.linspace(2595 * np.log10(1 + 30.0 / 700),
                          2595 * np.log10(1 + high_hz / 700),
                          out_channels + 1)
        hz = 700 * (10 ** (mel / 2595) - 1)
        self.low_hz = nn.Parameter(torch.tensor(
            hz[:-1, None], device=device, dtype=dtype))
        self.band_hz = nn.Parameter(torch.tensor(
            np.diff(hz)[:, None], device=device, dtype=dtype))

    def filters(self):
        """The (out_channels, kernel_size) band-pass taps."""
        low = self.min_low_hz + torch.abs(self.low_hz)
        high = torch.clamp(low + self.min_band_hz + torch.abs(self.band_hz),
                           self.min_low_hz, self.sample_rate / 2)
        K = self.kernel_size
        n = (K - 1) // 2
        dev, dt = low.device, low.dtype
        n_ = (2 * math.pi * torch.arange(-n, 0.0, device=dev, dtype=dt)[None]
              / self.sample_rate)
        window = (0.54 - 0.46 * torch.cos(
            2 * math.pi * torch.arange(K, device=dev, dtype=dt) / K))[:n]
        left = ((torch.sin(high * n_) - torch.sin(low * n_)) / (n_ / 2)
                ) * window
        center = 2 * (high - low)
        band_pass = torch.cat([left, center, left.flip(1)], dim=1)
        return band_pass / (2 * (high - low))

    def forward(self, x):
        if x.ndim == 2:
            x = x[..., None]
        if self.padding == "same":
            pads = _same_pad_1d(x.shape[1], self.kernel_size, self.stride,
                                self.dilation)
        else:
            pads = (0, 0)
        x = F.pad(x.transpose(1, 2), pads)
        return F.conv1d(x, self.filters()[:, None].to(x.dtype),
                        stride=self.stride,
                        dilation=self.dilation).transpose(1, 2)


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
                 padding_mode="reflect", weight_norm=False, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        # ``weight_norm`` is accepted and not read: the JAX module declares
        # it and normalises no weight
        self.weight_norm = weight_norm
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
        elif isinstance(self.padding, int):
            # flax's integer padding: that many zeros on every side
            pads = ((self.padding,) * 2,) * 2
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


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution (upsampling) on (batch, time, channel):
    ``L_out = (L - 1) * stride - 2 * padding + dilation * (K - 1) + 1 +
    output_padding``, the gradient of the convolution whose weight it
    holds, as ``torch.nn.ConvTranspose1d`` computes it. The weight is
    ``(in, out/groups, K)``; the JAX package's kernel ``(K, out,
    in/groups)`` carries over without a flip (``utils/jax_bridge``), both
    being the same convolution's gradient.

    Example
    -------
    >>> conv = ConvTranspose1d(out_channels=8, kernel_size=16, stride=8,
    ...                        in_channels=16, padding=4, device="cpu")
    >>> conv(torch.ones(2, 100, 16)).shape
    torch.Size([2, 800, 8])
    """

    def __init__(self, out_channels, kernel_size, in_channels, stride=1,
                 dilation=1, padding=0, output_padding=0, groups=1,
                 bias=True, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.padding = padding
        self.output_padding = output_padding
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels // groups, kernel_size,
            device=device, dtype=dtype,
        ))
        # flax's lecun_normal on its (K, out, in/groups) kernel: fan-in
        # out * K
        lecun_normal_(self.weight, out_channels * kernel_size, generator)
        self.bias = (
            nn.Parameter(torch.zeros(out_channels, device=device, dtype=dtype))
            if bias else None
        )

    def forward(self, x):
        y = F.conv_transpose1d(
            x.transpose(1, 2), self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            groups=self.groups, dilation=self.dilation,
        )
        return y.transpose(1, 2)


class GaborConv1d(nn.Module):
    """Learnable Gabor filters over a waveform (the LEAF front end):
    (batch, time[, 1]) -> (batch, time', out_channels), the first
    ``out_channels // 2`` channels the filters' real responses, the rest
    their imaginary ones, in the same order. A filter is a normalised
    Gaussian window of width ``sigma`` (at least 4 sqrt(2 ln 2) samples)
    times a complex sinusoid of normalised centre frequency; both start
    mel-spaced between ``min_freq`` and ``max_freq``. "same" padding is
    zeros.

    Example
    -------
    >>> conv = GaborConv1d(16, kernel_size=101, device="cpu")
    >>> conv(torch.ones(2, 800)).shape
    torch.Size([2, 800, 16])
    """

    def __init__(self, out_channels, kernel_size, stride=1, padding="same",
                 sample_rate=16000, min_freq=60.0, max_freq=None,
                 sort_filters=False, device="cuda", dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        n_filters = out_channels // 2
        max_freq = max_freq or sample_rate / 2
        mel_lo = 2595 * np.log10(1 + min_freq / 700)
        mel_hi = 2595 * np.log10(1 + max_freq / 700)
        hz = 700 * (10 ** (np.linspace(mel_lo, mel_hi, n_filters + 2)
                           / 2595) - 1)
        fwhms = (hz[2:] - hz[:-2]) / 2
        center_norm = hz[1:-1] * 2 * np.pi / sample_rate
        sigmas = sample_rate / (2 * np.pi * fwhms / np.sqrt(2 * np.log(2)))
        self.kernel_params = nn.Parameter(torch.tensor(
            np.stack([center_norm, sigmas], axis=1).astype(np.float32),
            device=device, dtype=dtype))

    def forward(self, x):
        if x.ndim == 2:
            x = x[..., None]
        K = self.kernel_size
        centers = self.kernel_params[:, 0:1]
        sigmas = self.kernel_params[:, 1:2].clamp(
            min=4 * math.sqrt(2 * math.log(2)))
        t = torch.arange(-(K // 2), K // 2 + 1.0, device=x.device)[None, :]
        denom = 1.0 / (math.sqrt(2 * math.pi) * sigmas)
        gauss = torch.exp(-(t**2) / (2 * sigmas**2))
        filters = torch.cat([denom * gauss * torch.cos(centers * t),
                             denom * gauss * torch.sin(centers * t)], dim=0)
        pads = (_same_pad_1d(x.shape[1], K, self.stride, 1)
                if self.padding == "same" else (0, 0))
        y = F.conv1d(F.pad(x.transpose(1, 2), pads),
                     filters[:, None, :].to(x.dtype), stride=self.stride)
        return y.transpose(1, 2)
