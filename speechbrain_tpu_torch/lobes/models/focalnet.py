"""1-D focal modulation networks (port of
``speechbrain_tpu/lobes/models/focalnet.py``: ``FocalModulation1d``,
``FocalBlock1d``, ``_FocalStack``, ``FocalEncoder``, ``FocalDecoder``
and ``FocalNetEncoder``).

A query is modulated by gated depthwise-convolution contexts at growing
receptive fields plus a global level (the mean over time of the last
level's context). Layout (B, T, C) throughout.

The JAX modules build flax's ``nn.Conv`` and ``nn.LayerNorm`` directly,
so their defaults are flax's, not the package wrappers': LayerNorm's
epsilon is 1e-6; a convolution's ``SAME`` padding is XLA's, which for a
stride s pads max((ceil(L/s) - 1) s + k - L, 0) frames in all, the
smaller half in front (a stage projection of kernel 4, stride 2 gives 10
frames from 20 and 11 from 21); ``jax.nn.gelu`` is the tanh
approximation. Submodules carry the flax scopes' names (``f``,
``focal_conv_{level}``, ``h``, ``proj``; ``norm1``, ``modulation``,
``norm2``, ``mlp_in``, ``mlp_out``; ``stage_proj_{i}``, ``block_{i}``;
``stack``, ``out``) and parameters theirs (``gamma1``, ``gamma2``,
``tanh_scale``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.linear import Linear, lecun_normal_
from speechbrain_tpu_torch.nnet.normalization import LayerNorm

# flax.linen.LayerNorm's default epsilon
FLAX_LN_EPS = 1e-6


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def xla_same_pads(length, kernel, stride):
    """(front, back) zero padding of XLA's ``SAME`` for one axis: the
    output keeps ceil(length / stride) frames."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class FlaxConv1d(nn.Module):
    """flax ``nn.Conv`` over (B, T, C): ``SAME`` (XLA's padding), or a
    ``(front, back)`` pair of zero frames; weight ``(out, in/groups,
    k)``."""

    def __init__(self, out_channels, in_channels, kernel_size, stride=1,
                 groups=1, padding="SAME", bias=True, device="cuda",
                 generator=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.groups, self.padding = groups, padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, device=device))
        lecun_normal_(self.weight, in_channels // groups * kernel_size,
                      generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x):
        pads = (xla_same_pads(x.shape[1], self.kernel_size, self.stride)
                if self.padding == "SAME" else tuple(self.padding))
        x = F.pad(x.transpose(1, 2), pads)
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        groups=self.groups).transpose(1, 2)


class FocalModulation1d(nn.Module):
    """out = proj(q(x) * h(sum of gated contexts)) over (B, T, dim).

    Example
    -------
    >>> m = FocalModulation1d(dim=16, device="cpu")
    >>> m(torch.ones(2, 20, 16)).shape
    torch.Size([2, 20, 16])
    """

    def __init__(self, dim, focal_window=7, focal_level=2, focal_factor=2,
                 normalize_modulator=False, causal=False, device="cuda",
                 generator=None):
        super().__init__()
        self.dim, self.focal_level = dim, focal_level
        self.normalize_modulator = normalize_modulator
        self.f = Linear(2 * dim + focal_level + 1, dim, device=device,
                        generator=generator)
        for level in range(focal_level):
            k = focal_factor * level + focal_window
            self.add_module(f"focal_conv_{level}", FlaxConv1d(
                dim, dim, k, groups=dim, bias=False,
                padding=(k - 1, 0) if causal else "SAME", device=device,
                generator=generator))
        self.h = FlaxConv1d(dim, dim, 1, device=device, generator=generator)
        self.proj = Linear(dim, dim, device=device, generator=generator)

    def forward(self, x):
        q, ctx, gates = torch.split(
            self.f(x), [self.dim, self.dim, self.focal_level + 1], dim=-1)
        ctx_all = torch.zeros_like(ctx)
        for level in range(self.focal_level):
            ctx = gelu(getattr(self, f"focal_conv_{level}")(ctx))
            ctx_all = ctx_all + ctx * gates[..., level:level + 1]
        # the global level: the mean over time of the last level's context
        glob = gelu(ctx.mean(dim=1, keepdim=True))
        ctx_all = ctx_all + glob * gates[..., self.focal_level:]
        if self.normalize_modulator:
            ctx_all = ctx_all / (self.focal_level + 1)
        return self.proj(q * self.h(ctx_all))


class FocalBlock1d(nn.Module):
    """Pre-norm (or post-norm) focal modulation and MLP, each with a
    residual and, under ``use_layerscale``, a learned per-channel scale
    (``gamma1``, ``gamma2``)."""

    def __init__(self, dim, focal_window=7, focal_level=2, focal_factor=2,
                 mlp_ratio=4.0, dropout=0.0, use_post_norm=False,
                 use_layerscale=False, layerscale_init=1e-4,
                 normalize_modulator=False, causal=False, device="cuda",
                 generator=None):
        super().__init__()
        self.use_post_norm = use_post_norm
        self.norm1 = LayerNorm(dim, eps=FLAX_LN_EPS, device=device)
        self.modulation = FocalModulation1d(
            dim, focal_window, focal_level, focal_factor,
            normalize_modulator, causal, device=device, generator=generator)
        self.norm2 = LayerNorm(dim, eps=FLAX_LN_EPS, device=device)
        hidden = int(dim * mlp_ratio)
        self.mlp_in = Linear(hidden, dim, device=device, generator=generator)
        self.mlp_out = Linear(dim, hidden, device=device, generator=generator)
        self.dropout = nn.Dropout(dropout)
        if use_layerscale:
            self.gamma1 = nn.Parameter(torch.full((dim,), layerscale_init,
                                                  device=device))
            self.gamma2 = nn.Parameter(torch.full((dim,), layerscale_init,
                                                  device=device))
        else:
            self.gamma1 = self.gamma2 = None

    @staticmethod
    def _scaled(gamma, y):
        return y if gamma is None else gamma * y

    def forward(self, x):
        h = x if self.use_post_norm else self.norm1(x)
        h = self.modulation(h)
        if self.use_post_norm:
            h = self.norm1(h)
        x = x + self._scaled(self.gamma1, h)
        h = x if self.use_post_norm else self.norm2(x)
        h = self.mlp_out(self.dropout(gelu(self.mlp_in(h))))
        if self.use_post_norm:
            h = self.norm2(h)
        return x + self._scaled(self.gamma2, h)


class _FocalStack(nn.Module):
    """Per stage: (under ``upsample``, each frame repeated k times) a
    channel projection (kernel max(2k, 3), stride k when downsampling,
    XLA's ``SAME``), then one ``FocalBlock1d``."""

    def __init__(self, input_dim, hidden_dims, scale_factors, upsample,
                 focal_window=7, focal_level=2, focal_factor=2, dropout=0.0,
                 use_post_norm=False, use_layerscale=False,
                 layerscale_init=1e-4, normalize_modulator=False,
                 causal=False, device="cuda", generator=None):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self.upsample = upsample
        width = input_dim
        for i, (dim, k) in enumerate(zip(hidden_dims, scale_factors)):
            stride = 1 if (upsample or k <= 1) else k
            self.add_module(f"stage_proj_{i}", FlaxConv1d(
                dim, width, max(2 * k, 3), stride=stride, device=device,
                generator=generator))
            self.add_module(f"block_{i}", FocalBlock1d(
                dim, focal_window, focal_level, focal_factor, dropout=dropout,
                use_post_norm=use_post_norm, use_layerscale=use_layerscale,
                layerscale_init=layerscale_init,
                normalize_modulator=normalize_modulator, causal=causal,
                device=device, generator=generator))
            width = dim

    def forward(self, x):
        for i, k in enumerate(self.scale_factors):
            if k > 1 and self.upsample:
                x = torch.repeat_interleave(x, k, dim=1)
            x = getattr(self, f"stage_proj_{i}")(x)
            x = getattr(self, f"block_{i}")(x)
        return x


class FocalEncoder(nn.Module):
    """FocalCodec's compressor: (B, T, input_dim) -> (B, T', output_dim)
    latents, ``tanh(tanh_scale * out(stack(x)))``.

    Example
    -------
    >>> enc = FocalEncoder(input_dim=8, output_dim=4, hidden_dims=(16, 8),
    ...                    downscale_factors=(1, 1), device="cpu")
    >>> enc(torch.ones(2, 12, 8)).shape
    torch.Size([2, 12, 4])
    """

    def __init__(self, input_dim, output_dim, hidden_dims=(1024, 512, 256),
                 downscale_factors=(1, 1, 1), focal_window=7, focal_level=2,
                 focal_factor=2, dropout=0.0, use_post_norm=False,
                 use_layerscale=False, layerscale_init=1e-4,
                 tanhscale_init=0.5, normalize_modulator=False, causal=False,
                 device="cuda", generator=None):
        super().__init__()
        self.stack = _FocalStack(
            input_dim, hidden_dims, downscale_factors, False, focal_window,
            focal_level, focal_factor, dropout, use_post_norm,
            use_layerscale, layerscale_init, normalize_modulator, causal,
            device=device, generator=generator)
        self.out = Linear(output_dim, hidden_dims[-1], device=device,
                          generator=generator)
        self.tanh_scale = nn.Parameter(torch.tensor(float(tanhscale_init),
                                                    device=device))

    def forward(self, x):
        return torch.tanh(self.tanh_scale * self.out(self.stack(x)))


class FocalDecoder(nn.Module):
    """FocalCodec's decompressor: (B, T', input_dim) -> (B, T,
    output_dim), the stack upsampling by repetition.

    Example
    -------
    >>> dec = FocalDecoder(input_dim=4, output_dim=8, hidden_dims=(8, 16),
    ...                    upscale_factors=(1, 1), device="cpu")
    >>> dec(torch.ones(2, 12, 4)).shape
    torch.Size([2, 12, 8])
    """

    def __init__(self, input_dim, output_dim, hidden_dims=(256, 512, 1024),
                 upscale_factors=(1, 1, 1), focal_window=7, focal_level=2,
                 focal_factor=2, dropout=0.0, use_post_norm=False,
                 use_layerscale=False, layerscale_init=1e-4,
                 normalize_modulator=False, causal=False, device="cuda",
                 generator=None):
        super().__init__()
        self.stack = _FocalStack(
            input_dim, hidden_dims, upscale_factors, True, focal_window,
            focal_level, focal_factor, dropout, use_post_norm,
            use_layerscale, layerscale_init, normalize_modulator, causal,
            device=device, generator=generator)
        self.out = Linear(output_dim, hidden_dims[-1], device=device,
                          generator=generator)

    def forward(self, x):
        return self.out(self.stack(x))


class FocalNetEncoder(nn.Module):
    """Focal-modulation classification encoder: (B, T, input_size)
    spectrogram frames -> (B, T', hidden_dims[-1]); under ``return_reps``
    also ``[out as a (B, T', 1, D) map]``.

    Example
    -------
    >>> enc = FocalNetEncoder(input_size=40, hidden_dims=(16, 8),
    ...                       downscale_factors=(2, 2), device="cpu")
    >>> enc(torch.ones(2, 20, 40)).shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, input_size=80, hidden_dims=(96, 192, 384, 768),
                 downscale_factors=(2, 2, 2, 2), focal_window=7,
                 focal_level=2, focal_factor=2, dropout=0.0,
                 return_reps=False, device="cuda", generator=None):
        super().__init__()
        self.return_reps = return_reps
        self.stack = _FocalStack(
            input_size, hidden_dims, downscale_factors, False, focal_window,
            focal_level, focal_factor, dropout, device=device,
            generator=generator)

    def forward(self, x):
        out = self.stack(x)
        if self.return_reps:
            return out, [out[:, :, None, :]]
        return out

