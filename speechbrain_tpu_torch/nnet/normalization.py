"""Normalization layers (port of ``LayerNorm``, ``BatchNorm1d``,
``BatchNorm2d``, ``GroupNorm``, ``InstanceNorm1d``, ``InstanceNorm2d``,
``ExponentialMovingAverage`` and ``PCEN`` from
``speechbrain_tpu/nnet/normalization.py``).

BatchNorm keeps its running statistics in buffers (``running_mean``,
``running_var``), which ride in the module's ``state_dict`` and so in every
checkpoint, and follows the module's ``train()``/``eval()``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm(nn.Module):
    """LayerNorm over the LAST axis only, whatever the input's rank.

    The JAX package's LayerNorm wraps ``flax.linen.LayerNorm``, which
    normalises the last axis; on the 4-D ``(B, T, F, C)`` tensors of the
    convolutional front end that is the channel axis alone (upstream
    SpeechBrain normalises the last two there — the port follows the JAX
    package).

    Example
    -------
    >>> ln = LayerNorm(input_size=40, device="cpu")
    >>> ln(torch.ones(4, 10, 40)).shape
    torch.Size([4, 10, 40])
    """

    def __init__(self, input_size, eps=1e-05, elementwise_affine=True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(
                torch.ones(input_size, device=device, dtype=dtype)
            )
            self.bias = nn.Parameter(
                torch.zeros(input_size, device=device, dtype=dtype)
            )
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return F.layer_norm(
            x, (self.input_size,), self.weight, self.bias, self.eps
        )


class BatchNorm1d(nn.Module):
    """BatchNorm over the channel (last) axis of ``(batch, time, channel)``
    or ``(batch, channel)`` inputs, as flax's ``BatchNorm`` computes it.

    In training mode the statistics are taken over every axis but the
    last, padded frames included, in float32: the mean and the biased
    variance ``E[x^2] - E[x]^2`` (clipped at 0). The running statistics
    move as ``r = momentum * r + (1 - momentum) * s`` with the same biased
    variance (``torch.nn.BatchNorm1d`` would fold in the unbiased one).
    In evaluation mode the running statistics normalise.

    Example
    -------
    >>> bn = BatchNorm1d(input_size=40, device="cpu")
    >>> bn(torch.ones(8, 120, 40)).shape
    torch.Size([8, 120, 40])
    """

    def __init__(self, input_size, eps=1e-5, momentum=0.9, affine=True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(
                torch.ones(input_size, device=device, dtype=dtype)
            )
            self.bias = nn.Parameter(
                torch.zeros(input_size, device=device, dtype=dtype)
            )
        else:
            self.weight = None
            self.bias = None
        self.register_buffer(
            "running_mean",
            torch.zeros(input_size, device=device, dtype=torch.float32),
        )
        self.register_buffer(
            "running_var",
            torch.ones(input_size, device=device, dtype=torch.float32),
        )

    def forward(self, x):
        xf = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.float()
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class BatchNorm2d(BatchNorm1d):
    """BatchNorm for ``(batch, time, feat, channel)`` inputs (NHWC): the
    statistics over batch, time and feature, one per channel."""


class GroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis of ``(batch, ..., channel)``
    inputs, as flax's ``GroupNorm`` computes it: the channels fall into
    ``num_groups`` groups, and each (sample, group) is normalised over
    every non-batch axis and the group's channels together, with the mean
    and the biased variance ``E[x^2] - E[x]^2`` (clipped at 0) in float32;
    then one scale and bias a channel. ``num_groups=1`` is the global
    layer norm of the separation models, over (time, channel) or (chunk,
    chunks, channel).

    Example
    -------
    >>> gn = GroupNorm(input_size=8, num_groups=1, eps=1e-8, device="cpu")
    >>> gn(torch.ones(2, 5, 3, 8)).shape
    torch.Size([2, 5, 3, 8])
    """

    def __init__(self, input_size, num_groups=32, eps=1e-05, affine=True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        if input_size % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{input_size} channels")
        self.input_size = input_size
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(
                torch.ones(input_size, device=device, dtype=dtype)
            )
            self.bias = nn.Parameter(
                torch.zeros(input_size, device=device, dtype=dtype)
            )
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        G = self.num_groups
        xf = x.float().reshape(*x.shape[:-1], G, x.shape[-1] // G)
        dims = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
        mean = xf.mean(dims, keepdim=True)
        var = torch.clamp((xf * xf).mean(dims, keepdim=True) - mean * mean,
                          min=0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        if self.weight is not None:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class InstanceNorm1d(nn.Module):
    """Per-sample, per-channel normalisation of (batch, time, channel) over
    time, padded frames included, as the JAX package computes it: the mean
    and the biased variance of each (sample, channel), ``(x - mean) *
    rsqrt(var + eps)``, then one scale and bias a channel where
    ``affine``. No running statistics: training and evaluation agree.

    Example
    -------
    >>> norm = InstanceNorm1d(8, affine=True, device="cpu")
    >>> norm(torch.ones(2, 5, 8)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, input_size, eps=1e-05, affine=False, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(
                torch.ones(input_size, device=device, dtype=dtype)
            )
            self.bias = nn.Parameter(
                torch.zeros(input_size, device=device, dtype=dtype)
            )
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=1, correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class InstanceNorm2d(InstanceNorm1d):
    """Per-sample, per-channel normalisation of (batch, time, feat,
    channel) over time and feature together, as :class:`InstanceNorm1d`
    normalises over time (biased variance, no running statistics, one
    scale and bias a channel where ``affine``).

    Example
    -------
    >>> InstanceNorm2d(4, affine=True, device="cpu")(torch.ones(2, 5, 3, 4)).shape
    torch.Size([2, 5, 3, 4])
    """

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(1, 2), correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class ExponentialMovingAverage(nn.Module):
    """First-order lowpass over time of (batch, time, channel):
    ``s[t] = w * x[t] + (1 - w) * s[t-1]`` from ``s[-1] = x[0]``, with a
    learnable coefficient ``w`` (clipped to [0, 1]), one a channel or one
    for all: the PCEN smoother. The JAX package scans the frames; here a
    loop over them does the same arithmetic in the same order.

    Example
    -------
    >>> ema = ExponentialMovingAverage(8, per_channel=True, device="cpu")
    >>> ema(torch.ones(2, 5, 8)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, input_size, coeff_init=0.04, per_channel=False,
                 trainable=True, device="cuda", dtype=torch.float32):
        super().__init__()
        shape = (input_size,) if per_channel else (1,)
        self.weights = nn.Parameter(
            torch.full(shape, coeff_init, device=device, dtype=dtype),
            requires_grad=trainable)

    def forward(self, x):
        w = self.weights.clamp(0.0, 1.0)
        s = x[:, 0, :]
        out = []
        for t in range(x.shape[1]):
            s = w * x[:, t, :] + (1.0 - w) * s
            out.append(s)
        return torch.stack(out, dim=1)


class PCEN(nn.Module):
    """Trainable per-channel energy normalisation of (batch, time,
    channel): ``(x / (floor + EMA(x)) ** alpha + delta) ** (1 / root) -
    delta ** (1 / root)`` with ``alpha`` clipped at 1 and ``root`` at
    least 1, each a channel.

    Example
    -------
    >>> pcen = PCEN(8, device="cpu")
    >>> pcen(torch.ones(2, 5, 8)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, input_size, alpha=0.96, smooth_coef=0.04, delta=2.0,
                 root=2.0, floor=1e-12, trainable=True,
                 per_channel_smooth_coef=True, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.floor = floor

        def const(v):
            return nn.Parameter(torch.full((input_size,), v, device=device,
                                           dtype=dtype))

        self.alpha = const(alpha)
        self.delta = const(delta)
        self.root = const(root)
        self.ema = ExponentialMovingAverage(
            input_size, coeff_init=smooth_coef,
            per_channel=per_channel_smooth_coef, trainable=trainable,
            device=device, dtype=dtype)

    def forward(self, x):
        ema = self.ema(x)
        alpha = self.alpha.clamp(max=1.0)
        one_over_root = 1.0 / self.root.clamp(min=1.0)
        return ((x / (self.floor + ema) ** alpha + self.delta)
                ** one_over_root - self.delta ** one_over_root)
