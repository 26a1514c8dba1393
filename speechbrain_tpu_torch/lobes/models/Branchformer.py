"""Branchformer encoder (port of
``speechbrain_tpu/lobes/models/Branchformer.py``): two parallel branches a
layer, self-attention (global) and a convolutional gating MLP, cgMLP
(local), merged by concatenation and a projection. There is no attention
mask: ``TransformerASR`` hands a branchformer none.
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    _make_attention,
    run_layer,
)
from speechbrain_tpu_torch.nnet.activations import gelu
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import LayerNorm


class ConvolutionalSpatialGatingUnit(nn.Module):
    """CSGU: split the channels into (a, b), LayerNorm b, run a depthwise
    'same' convolution over time on it (reflect padding), gate a with it."""

    def __init__(self, input_size, kernel_size=31, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        half = input_size // 2
        self.norm = LayerNorm(half, device=device, dtype=dtype)
        self.dw_conv = Conv1d(
            out_channels=half, kernel_size=kernel_size, in_channels=half,
            groups=half, device=device, dtype=dtype, generator=generator,
        )

    def forward(self, x):
        a, b = torch.chunk(x, 2, dim=-1)
        return a * self.dw_conv(self.norm(b))


class ConvolutionBranch(nn.Module):
    """cgMLP branch: channel-expanding MLP with spatial gating."""

    def __init__(self, input_size, linear_units=3072, kernel_size=31,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up = Linear(linear_units, input_size, **kw)
        self.csgu = ConvolutionalSpatialGatingUnit(
            linear_units, kernel_size=kernel_size, **kw
        )
        self.down = Linear(input_size, linear_units // 2, **kw)

    def forward(self, x):
        return self.down(self.csgu(gelu(self.up(x))))


class BranchformerEncoderLayer(nn.Module):
    """One Branchformer layer: x + merge([attention(LN x), cgMLP(LN x)])."""

    def __init__(self, d_model, nhead, kernel_size=31,
                 attention_type="RelPosMHAXL", csgu_linear_units=3072,
                 dropout=0.0, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.norm_attn = LayerNorm(d_model, device=device, dtype=dtype)
        self.attn = _make_attention(
            attention_type, d_model, nhead, dropout, **kw
        )
        self.norm_conv = LayerNorm(d_model, device=device, dtype=dtype)
        self.cgmlp = ConvolutionBranch(
            d_model, linear_units=csgu_linear_units, kernel_size=kernel_size,
            **kw,
        )
        self.merge = Linear(d_model, 2 * d_model, **kw)

    def forward(self, x, src_key_padding_mask=None, pos_embs=None):
        a = self.norm_attn(x)
        a, attn_w = self.attn(
            a, a, a, key_padding_mask=src_key_padding_mask, pos_embs=pos_embs
        )
        c = self.cgmlp(self.norm_conv(x))
        return x + self.merge(torch.cat([a, c], dim=-1)), attn_w


class BranchformerEncoder(nn.Module):
    """Stack of Branchformer layers with a final LayerNorm (``norm_out``).

    ``remat=True`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``, the counterpart of the ``jax.checkpoint``
    that the JAX package's other encoders take); the recomputation replays
    the layer's random state, so dropout draws the same masks.

    Example
    -------
    >>> enc = BranchformerEncoder(num_layers=2, d_model=32, nhead=4,
    ...     csgu_linear_units=64, kernel_size=7, device="cpu")
    >>> out, attns = enc(torch.ones(2, 16, 32))
    >>> out.shape
    torch.Size([2, 16, 32])
    """

    def __init__(self, num_layers, d_model, nhead, kernel_size=31,
                 attention_type="RelPosMHAXL", csgu_linear_units=3072,
                 dropout=0.0, remat=False, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            BranchformerEncoderLayer(
                d_model=d_model, nhead=nhead, kernel_size=kernel_size,
                attention_type=attention_type,
                csgu_linear_units=csgu_linear_units, dropout=dropout,
                device=device, dtype=dtype, generator=generator,
            )
            for _ in range(num_layers)
        ])
        self.norm_out = LayerNorm(d_model, device=device, dtype=dtype)

    def forward(self, src, src_key_padding_mask=None, pos_embs=None):
        out = src
        attns = []
        for layer in self.layers:
            out, w = run_layer(
                layer, self.remat, out, src_key_padding_mask, pos_embs
            )
            attns.append(w)
        return self.norm_out(out), attns

