"""Pooling layers (port of ``speechbrain_tpu/nnet/pooling.py``:
``Pooling1d``, ``Pooling2d``, ``StatisticsPooling``, ``AdaptivePool``,
``GaussianLowpassPooling`` and ``AttentionPooling``).

Windows are VALID after the explicit padding: a remainder shorter than the
window is dropped (floor mode). Max pooling pads with -inf, average
pooling with zeros that count in the mean (the JAX package divides each
window's sum by the window's size).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.linear import lecun_normal_


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


def length_mask(x, lengths):
    """(B, T, 1) float32 mask of ``x`` (B, T, ...): True below
    ``round(lengths * T)`` (half to even, as ``jnp.round``)."""
    T = x.shape[1]
    valid = torch.round(lengths.float() * T)
    idx = torch.arange(T, device=x.device)
    return (idx[None, :] < valid[:, None]).to(torch.float32)[..., None]


class StatisticsPooling(nn.Module):
    """Mean and standard deviation over time of (batch, time, channel) ->
    (batch, 1, 2 * channel), the x-vector pooling. With ``lengths``
    (relative) the frames past ``round(lengths * T)`` are left out and
    the deviation is ``sqrt(var + eps)``; without, it is the population
    deviation. Computes in float32.

    Example
    -------
    >>> StatisticsPooling()(torch.ones(5, 100, 50)).shape
    torch.Size([5, 1, 100])
    """

    def __init__(self, return_mean=True, return_std=True, eps=1e-5):
        super().__init__()
        self.return_mean = return_mean
        self.return_std = return_std
        self.eps = eps

    def forward(self, x, lengths=None):
        x = x.float()
        if lengths is None:
            mean = x.mean(dim=1)
            std = x.std(dim=1, unbiased=False)
        else:
            mask = length_mask(x, lengths)
            denom = mask.sum(dim=1).clamp(min=1.0)
            mean = (x * mask).sum(dim=1) / denom
            var = (((x - mean[:, None, :]) ** 2) * mask).sum(dim=1) / denom
            std = torch.sqrt(var + self.eps)
        outs = []
        if self.return_mean:
            outs.append(mean)
        if self.return_std:
            outs.append(std)
        return torch.cat(outs, dim=-1)[:, None, :]


class AdaptivePool(nn.Module):
    """Average of (batch, time, channel) over ``output_size`` segments of
    time (``numpy.linspace`` edges, each at least one frame).

    Example
    -------
    >>> AdaptivePool(4)(torch.ones(2, 10, 3)).shape
    torch.Size([2, 4, 3])
    """

    def __init__(self, output_size=1):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        T = x.shape[1]
        if self.output_size == 1:
            return x.mean(dim=1, keepdim=True)
        edges = np.linspace(0, T, self.output_size + 1).astype(int)
        return torch.stack([
            x[:, edges[i]:max(edges[i + 1], edges[i] + 1)].mean(dim=1)
            for i in range(self.output_size)
        ], dim=1)


class GaussianLowpassPooling(nn.Module):
    """LEAF's learnable lowpass pooling over time: a depthwise strided
    convolution of (batch, time, channel) whose kernel a channel is a
    Gaussian window of width ``clip(weights, 2 / K, 0.5) * K / 2`` about
    the kernel's centre (zero padding of (K-1)//2 before, K//2 after).

    Example
    -------
    >>> pool = GaussianLowpassPooling(8, kernel_size=11, stride=5,
    ...                               device="cpu")
    >>> pool(torch.ones(2, 50, 8)).shape
    torch.Size([2, 10, 8])
    """

    def __init__(self, in_channels, kernel_size=401, stride=160,
                 initialization_constant=0.4, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.weights = nn.Parameter(torch.full(
            (in_channels,), initialization_constant, device=device,
            dtype=dtype))

    def forward(self, x):
        K = self.kernel_size
        w = self.weights.clamp(2.0 / K, 0.5)
        t = torch.arange(K, device=x.device, dtype=torch.float32)
        den = w[:, None] * K / 2.0
        kernel = torch.exp(-0.5 * ((t[None, :] - (K - 1) / 2.0) / den) ** 2)
        y = F.conv1d(F.pad(x.transpose(1, 2), ((K - 1) // 2, K // 2)),
                     kernel[:, None, :].to(x.dtype), stride=self.stride,
                     groups=x.shape[-1])
        return y.transpose(1, 2)


class AttentionPooling(nn.Module):
    """Single-query attention over time: (batch, time, dim) -> (batch,
    dim), weights the softmax over time of ``x @ query``.

    Example
    -------
    >>> AttentionPooling(16, device="cpu")(torch.ones(2, 7, 16)).shape
    torch.Size([2, 16])
    """

    def __init__(self, input_dim, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.query = nn.Parameter(
            torch.empty(input_dim, 1, device=device, dtype=dtype))
        lecun_normal_(self.query, input_dim, generator)

    def forward(self, x):
        weights = torch.softmax((x @ self.query)[..., 0].float(), dim=-1)
        return (x.float() * weights[..., None]).sum(dim=1).to(x.dtype)
