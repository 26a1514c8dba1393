"""Conformer encoder and decoder (port of
``speechbrain_tpu/lobes/models/transformer/Conformer.py``), with dynamic
chunk training and chunk-by-chunk streaming.

Dynamic chunk training: with a ``DynChunkTrainConfig`` the attention sees
a frame's own chunk and ``left_context_size`` chunks before it
(``make_chunked_attention_mask``), and the depthwise convolution sees its
own chunk, ``(kernel_size - 1) // 2`` frames before it and zeros after it
(``ConvolutionModule``'s chunked arm).

Streaming (``forward_streaming``) computes the same function chunk by
chunk: each layer keeps the attention's input over the left context and
the depthwise convolution's input (after the GLU) over its left half
window. At stream start both are empty, so the convolution pads with
zeros where the chunked offline encode does. The JAX package carries the
convolution module's input instead, before its LayerNorm, pointwise
convolution and GLU, and starts it at zeros, so that a stream's first
frames see GLU(pw1(LayerNorm(0))) in place of zeros: its streamed output
departs from its chunked offline encode wherever those biases are not
zero (ROADMAP.md C34). The port's does not.
"""

from dataclasses import dataclass, field
from typing import Any

import numpy as np
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


def make_chunked_attention_mask(T, chunk_size, left_context_chunks=None,
                                device="cuda"):
    """(T, T) bool mask, True where masked: frame i attends within its
    chunk and up to ``left_context_chunks`` chunks before it (all of them
    where None).

    Example
    -------
    >>> make_chunked_attention_mask(4, 2, device="cpu").int().tolist()
    [[0, 0, 1, 1], [0, 0, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]]
    """
    chunk_id = np.arange(T) // chunk_size
    q = chunk_id[:, None]
    k = chunk_id[None, :]
    allowed = k <= q
    if left_context_chunks is not None:
        allowed &= k >= (q - left_context_chunks)
    return torch.from_numpy(~allowed).to(device)


@dataclass
class ConformerEncoderLayerStreamingContext:
    """Streaming state of one layer: the attention's input over the last
    ``mha_left_context_size`` frames (all frames where None), and the
    depthwise convolution's input (after the GLU) over its left half
    window; both None before the first chunk."""

    mha_left_context_size: Any = None
    mha_left_context: Any = None
    dcconv_left_context: Any = None


@dataclass
class ConformerEncoderStreamingContext:
    """Streaming state of a whole encoder: its chunk configuration and a
    :class:`ConformerEncoderLayerStreamingContext` a layer."""

    dynchunktrain_config: Any
    layers: list = field(default_factory=list)


class ConvolutionModule(nn.Module):
    """Conformer convolution module:
    LN -> pointwise(2x, GLU) -> depthwise -> LN(+swish) -> pointwise.

    ``causal`` uses left-only padding. The depthwise conv is VALID and
    the padding is done by hand before it. With a dynamic chunk
    configuration (and not ``causal``) each chunk is convolved over its
    window ``[(kernel_size - 1) // 2 frames before it | the chunk |
    zeros]``, so that no frame sees a later chunk (``forward_streaming``
    computes the same chunk by chunk).
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

    def _gated(self, x):
        y = self.pw1(self.layer_norm(x))
        a, b = torch.chunk(y, 2, dim=-1)
        return a * torch.sigmoid(b)  # GLU

    def _tail(self, y, mask=None):
        y = swish(self.mid_norm(y))
        y = self.pw2(y)
        y = F.dropout(y, self.dropout, self.training)
        if mask is not None and mask.ndim == 2:
            y = y.masked_fill(mask[..., None], 0.0)
        return y

    def _chunked_depthwise(self, y, chunk_size):
        """The depthwise conv over each chunk's window, as one grouped
        conv over the windows (B * chunks, C, half + chunk + half)."""
        if self.dilation != 1:
            raise ValueError("the chunked convolution needs dilation 1")
        B, T, C = y.shape
        half = (self.kernel_size - 1) // 2
        pad_t = (-T) % chunk_size
        n_chunks = (T + pad_t) // chunk_size
        # (B, n_chunks, C, half + chunk): each chunk and its left context
        windows = F.pad(y, (0, 0, half, pad_t)).unfold(
            1, half + chunk_size, chunk_size)
        windows = F.pad(windows, (0, half)).reshape(
            B * n_chunks, C, 2 * half + chunk_size)
        out = F.conv1d(windows, self.dw.weight, self.dw.bias,
                       groups=self.dw.groups)  # (B * n_chunks, C, chunk)
        out = out.reshape(B, n_chunks, C, chunk_size).transpose(2, 3)
        return out.reshape(B, n_chunks * chunk_size, C)[:, :T]

    def forward(self, x, mask=None, dynchunktrain_config=None):
        y = self._gated(x)
        if dynchunktrain_config is not None and not self.causal:
            y = self._chunked_depthwise(y, dynchunktrain_config.chunk_size)
        else:
            eff = (self.kernel_size - 1) * self.dilation
            if self.causal:
                y = F.pad(y, (0, 0, eff, 0))
            else:
                y = F.pad(y, (0, 0, eff // 2, eff - eff // 2))
            y = self.dw(y)
        return self._tail(y, mask)

    def forward_streaming(self, x, left_context=None):
        """One chunk (B, T, D) with the GLU outputs of the frames before it
        (``left_context``, None at stream start: zeros); returns (output,
        the new left context). Not for a ``causal`` module."""
        if self.causal or self.dilation != 1:
            raise ValueError("streaming needs a centred, undilated module")
        y = self._gated(x)
        B, T, C = y.shape
        half = (self.kernel_size - 1) // 2
        if left_context is None:
            left_context = y.new_zeros(B, half, C)
        y = torch.cat([left_context, y], dim=1)
        new_left = y[:, y.shape[1] - half:]
        out = self.dw(F.pad(y, (0, 0, 0, half)))
        return self._tail(out), new_left


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
                pos_embs=None, dynchunktrain_config=None):
        x = x + 0.5 * self.ffn1(self.norm_ff1(x))
        y = self.norm_mha(x)
        y, attn_w = self.attn(
            y, y, y, attn_mask=src_mask,
            key_padding_mask=src_key_padding_mask, pos_embs=pos_embs,
        )
        x = x + y
        x = x + self.conv(x, dynchunktrain_config=dynchunktrain_config)
        x = x + 0.5 * self.ffn2(self.norm_ff2(x))
        return self.norm_out(x), attn_w

    def forward_streaming(self, x, context, pos_embs=None):
        """One chunk (B, T, D) through the layer with the state of the
        chunks before it (a :class:`ConformerEncoderLayerStreamingContext`,
        updated in place). The attention runs over the left context and
        the chunk (its relative positions made for that length where
        ``pos_embs`` is None), and the chunk's rows are kept."""
        T = x.shape[1]
        x = x + 0.5 * self.ffn1(self.norm_ff1(x))
        if context.mha_left_context is not None:
            x = torch.cat([context.mha_left_context, x], dim=1)
        size = context.mha_left_context_size
        if size is None:
            context.mha_left_context = x
        elif size > 0:
            context.mha_left_context = x[:, max(x.shape[1] - size, 0):]
        y = self.norm_mha(x)
        y, _ = self.attn(y, y, y, pos_embs=pos_embs)
        x = (x + y)[:, -T:]
        y, context.dcconv_left_context = self.conv.forward_streaming(
            x, context.dcconv_left_context)
        x = x + y
        x = x + 0.5 * self.ffn2(self.norm_ff2(x))
        return self.norm_out(x)

    @staticmethod
    def make_streaming_context(mha_left_context_size):
        return ConformerEncoderLayerStreamingContext(
            mha_left_context_size=mha_left_context_size)


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
                pos_embs=None, dynchunktrain_config=None):
        output = src
        attns = []
        for layer in self.layers:
            output, attn = run_layer(
                layer, self.remat, output, src_mask, src_key_padding_mask,
                pos_embs, dynchunktrain_config,
            )
            attns.append(attn)
        return self.norm(output), attns

    def forward_streaming(self, src, context, pos_embs=None):
        """One chunk (B, T, D) through every layer; ``context`` (a
        :class:`ConformerEncoderStreamingContext`) is updated in place.
        Returns the chunk's output."""
        output = src
        for layer, layer_context in zip(self.layers, context.layers):
            output = layer.forward_streaming(output, layer_context, pos_embs)
        return self.norm(output)

    def make_streaming_context(self, dynchunktrain_config):
        """The state before a stream's first chunk: each layer's attention
        keeps ``dynchunktrain_config.left_context_size_frames()`` frames
        (all of them for an unlimited left context)."""
        return ConformerEncoderStreamingContext(
            dynchunktrain_config=dynchunktrain_config,
            layers=[
                ConformerEncoderLayer.make_streaming_context(
                    dynchunktrain_config.left_context_size_frames())
                for _ in self.layers
            ],
        )


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
