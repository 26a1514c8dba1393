"""Conformer encoder and decoder (port of the full-context arm of
``speechbrain_tpu/lobes/models/transformer/Conformer.py``; the dynamic
chunk and streaming paths are not ported yet).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerDecoder,
    _make_attention,
    run_layer,
)
from speechbrain_tpu_torch.nnet.activations import swish
from speechbrain_tpu_torch.nnet.attention import PositionalwiseFeedForward
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.normalization import LayerNorm


class ConvolutionModule(nn.Module):
    """Conformer convolution module:
    LN -> pointwise(2x, GLU) -> depthwise -> LN(+swish) -> pointwise.

    ``causal`` uses left-only padding. The depthwise conv is VALID and
    the padding is done by hand before it.
    """

    def __init__(self, input_size, kernel_size=31, bias=True, causal=False,
                 dilation=1, dropout=0.0, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.kernel_size = kernel_size
        self.causal = causal
        self.dilation = dilation
        self.dropout = dropout
        self.layer_norm = LayerNorm(input_size, device=device, dtype=dtype)
        self.pw1 = Conv1d(
            out_channels=2 * input_size, kernel_size=1,
            in_channels=input_size, bias=bias, **kw,
        )
        self.dw = Conv1d(
            out_channels=input_size, kernel_size=kernel_size,
            in_channels=input_size, groups=input_size, padding="valid",
            dilation=dilation, bias=bias, **kw,
        )
        self.mid_norm = LayerNorm(input_size, device=device, dtype=dtype)
        self.pw2 = Conv1d(
            out_channels=input_size, kernel_size=1, in_channels=input_size,
            bias=bias, **kw,
        )

    def forward(self, x, mask=None):
        y = self.layer_norm(x)
        y = self.pw1(y)
        a, b = torch.chunk(y, 2, dim=-1)
        y = a * torch.sigmoid(b)  # GLU
        eff = (self.kernel_size - 1) * self.dilation
        if self.causal:
            y = F.pad(y, (0, 0, eff, 0))
        else:
            y = F.pad(y, (0, 0, eff // 2, eff - eff // 2))
        y = self.dw(y)
        y = swish(self.mid_norm(y))
        y = self.pw2(y)
        y = F.dropout(y, self.dropout, self.training)
        if mask is not None and mask.ndim == 2:
            y = y.masked_fill(mask[..., None], 0.0)
        return y


class ConformerEncoderLayer(nn.Module):
    """Half-FFN + MHSA + Conv + half-FFN + LN."""

    def __init__(self, d_model, d_ffn, nhead, kernel_size=31,
                 activation="swish", bias=True, dropout=0.0, causal=False,
                 attention_type="RelPosMHAXL", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        norm_kw = dict(device=device, dtype=dtype)
        self.norm_ff1 = LayerNorm(d_model, **norm_kw)
        self.ffn1 = PositionalwiseFeedForward(
            d_ffn=d_ffn, input_size=d_model, dropout=dropout,
            activation=activation, **kw,
        )
        self.norm_mha = LayerNorm(d_model, **norm_kw)
        self.attn = _make_attention(
            attention_type, d_model, nhead, dropout, **kw
        )
        self.conv = ConvolutionModule(
            input_size=d_model, kernel_size=kernel_size, bias=bias,
            causal=causal, dropout=dropout, **kw,
        )
        self.norm_ff2 = LayerNorm(d_model, **norm_kw)
        self.ffn2 = PositionalwiseFeedForward(
            d_ffn=d_ffn, input_size=d_model, dropout=dropout,
            activation=activation, **kw,
        )
        self.norm_out = LayerNorm(d_model, **norm_kw)

    def forward(self, x, src_mask=None, src_key_padding_mask=None,
                pos_embs=None):
        x = x + 0.5 * self.ffn1(self.norm_ff1(x))
        y = self.norm_mha(x)
        y, attn_w = self.attn(
            y, y, y, attn_mask=src_mask,
            key_padding_mask=src_key_padding_mask, pos_embs=pos_embs,
        )
        x = x + y
        x = x + self.conv(x)
        x = x + 0.5 * self.ffn2(self.norm_ff2(x))
        return self.norm_out(x), attn_w


class ConformerEncoder(nn.Module):
    """Stack of Conformer layers with a final eps-1e-6 LayerNorm.

    ``remat=True`` recomputes each layer in the backward pass
    (``Transformer.run_layer``: ``torch.utils.checkpoint``, dropout masks
    replayed).

    Example
    -------
    >>> enc = ConformerEncoder(num_layers=2, d_model=32, d_ffn=64, nhead=4,
    ...                        device="cpu")
    >>> out, attns = enc(torch.ones(2, 16, 32))
    >>> out.shape
    torch.Size([2, 16, 32])
    """

    def __init__(self, num_layers, d_model, d_ffn, nhead, kernel_size=31,
                 activation="swish", bias=True, dropout=0.0, causal=False,
                 attention_type="RelPosMHAXL", remat=False, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList([
            ConformerEncoderLayer(
                d_model=d_model, d_ffn=d_ffn, nhead=nhead,
                kernel_size=kernel_size, activation=activation, bias=bias,
                dropout=dropout, causal=causal,
                attention_type=attention_type, device=device, dtype=dtype,
                generator=generator,
            )
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(d_model, eps=1e-6, device=device, dtype=dtype)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None):
        output = src
        attns = []
        for layer in self.layers:
            output, attn = run_layer(
                layer, self.remat, output, src_mask, src_key_padding_mask,
                pos_embs,
            )
            attns.append(attn)
        return self.norm(output), attns


class ConformerDecoder(nn.Module):
    """Conformer-style decoder: a ``TransformerDecoder`` (``dec``) of
    post-norm layers with the swish activation (the JAX package's
    ``kernel_size`` field, which it never reads, is not taken). Returns
    (out, self-attention weights, cross-attention weights).

    Example
    -------
    >>> dec = ConformerDecoder(num_layers=1, d_model=16, d_ffn=32, nhead=2,
    ...                        device="cpu")
    >>> out, _, _ = dec(torch.ones(2, 5, 16), torch.ones(2, 7, 16))
    >>> out.shape
    torch.Size([2, 5, 16])
    """

    def __init__(self, num_layers, d_model, d_ffn, nhead, dropout=0.0,
                 activation="swish",
                 attention_type="regularMHA", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dec = TransformerDecoder(
            num_layers=num_layers, nhead=nhead, d_ffn=d_ffn, d_model=d_model,
            dropout=dropout, activation=activation,
            attention_type=attention_type, device=device, dtype=dtype,
            generator=generator,
        )

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                pos_embs_tgt=None, pos_embs_src=None):
        return self.dec(
            tgt, memory, tgt_mask, memory_mask, tgt_key_padding_mask,
            memory_key_padding_mask, pos_embs_tgt, pos_embs_src,
        )
