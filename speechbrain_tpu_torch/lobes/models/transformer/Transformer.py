"""Transformer encoder/decoder core (port of
``speechbrain_tpu/lobes/models/transformer/Transformer.py``).

Incremental decoding keeps an explicit cache: a list with one
``{"self": {"k", "v"}[, "cross": {"k", "v"}]}`` dict per layer. The
``self`` buffers are written in place, so the cache a layer returns is
the cache it was given.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from speechbrain_tpu_torch.nnet.attention import (
    MultiheadAttention,
    PositionalwiseFeedForward,
    RelPosMHAXL,
    RoPEMHA,
)
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.hypermixing import HyperMixing
from speechbrain_tpu_torch.nnet.normalization import LayerNorm

# KV caches are allocated in whole multiples of this many positions, as in
# the JAX package (whose kernel tiles time by 32); positions past the
# requested length sit beyond the causal mask
CACHE_LENGTH_MULTIPLE = 32


def get_lookahead_mask(T, device="cuda"):
    """Causal (True = masked) (T, T) bool mask, made on ``device`` (an
    upload from the host would wait for the device's queue)."""
    return torch.ones(T, T, dtype=torch.bool, device=device).triu_(1)


def get_key_padding_mask(padded_input_len, max_len):
    """(B, T) bool mask, True at padded positions, from relative lengths."""
    lens = torch.round(padded_input_len * max_len).to(torch.int32)
    return (
        torch.arange(max_len, device=lens.device)[None, :] >= lens[:, None]
    )


class PositionalEncoding(nn.Module):
    """Absolute sinusoidal positional encoding: (B, T, D) -> (1, T, D).

    Example
    -------
    >>> pe = PositionalEncoding(input_size=16, device="cpu")
    >>> pe(torch.zeros(2, 10, 16)).shape
    torch.Size([1, 10, 16])
    """

    def __init__(self, input_size, max_len=2500, device="cuda"):
        super().__init__()
        pe = np.zeros((max_len, input_size), dtype=np.float32)
        positions = np.arange(max_len, dtype=np.float32)[:, None]
        denom = np.exp(
            np.arange(0, input_size, 2, dtype=np.float32)
            * -(math.log(10000.0) / input_size)
        )
        pe[:, 0::2] = np.sin(positions * denom)
        pe[:, 1::2] = np.cos(positions * denom)
        self.register_buffer(
            "pe", torch.from_numpy(pe[None]).to(device), persistent=False
        )

    def forward(self, x, offset=0):
        """The encodings of positions ``offset`` to ``offset + T``."""
        end = offset + x.shape[1]
        if end > self.pe.shape[1]:
            raise ValueError(f"position {end - 1} is past max_len "
                             f"{self.pe.shape[1]}")
        return self.pe[:, offset:end].to(x.dtype)

    def at(self, position, dtype):
        """The encoding of one position, (1, 1, D), for a decode step."""
        return self.pe[:, position: position + 1].to(dtype)


class NormalizedEmbedding(nn.Module):
    """Embedding scaled by sqrt(d_model)."""

    def __init__(self, d_model, vocab, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.d_model = d_model
        self.emb = Embedding(
            num_embeddings=vocab, embedding_dim=d_model, device=device,
            dtype=dtype, generator=generator,
        )

    def forward(self, x):
        return self.emb(x) * math.sqrt(self.d_model)


def _make_attention(attention_type, d_model, nhead, dropout, **kw):
    if attention_type == "regularMHA":
        return MultiheadAttention(
            nhead=nhead, d_model=d_model, dropout=dropout, **kw
        )
    if attention_type == "RelPosMHAXL":
        return RelPosMHAXL(
            embed_dim=d_model, num_heads=nhead, dropout=dropout, **kw
        )
    if attention_type == "RoPEMHA":
        return RoPEMHA(nhead=nhead, d_model=d_model, dropout=dropout, **kw)
    if attention_type == "hypermixing":
        # token mixing in place of attention (the HyperConformer and
        # HyperBranchformer configurations)
        return HyperMixing(
            input_output_dim=d_model, hypernet_size=d_model * 4,
            num_heads=nhead, tied=False, **kw,
        )
    raise ValueError(f"Unknown attention_type {attention_type}")


def run_layer(layer, remat, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when ``remat`` is
    set and a gradient is being recorded: the layer's activations are
    recomputed in the backward pass instead of kept (the counterpart of the
    JAX package's ``nn.remat``). Non-reentrant, and the random state is
    replayed, so dropout draws the same masks in the recomputation."""
    if remat and torch.is_grad_enabled():
        return checkpoint(
            layer, *args, use_reentrant=False, preserve_rng_state=True
        )
    return layer(*args)


def _init_cache(num_layers, batch_size, max_len, d_model, device, dtype):
    max_len = -(-max_len // CACHE_LENGTH_MULTIPLE) * CACHE_LENGTH_MULTIPLE
    return [
        {
            "self": {
                "k": torch.zeros(
                    batch_size, max_len, d_model, device=device, dtype=dtype
                ),
                "v": torch.zeros(
                    batch_size, max_len, d_model, device=device, dtype=dtype
                ),
            }
        }
        for _ in range(num_layers)
    ]


class TransformerEncoderLayer(nn.Module):
    """Self-attention + FFN with pre/post-norm.

    ``ffn_type="1dcnn"`` replaces the linear FFN with two 'same' 1-D
    convolutions (reflect padding) of kernel sizes
    ``ffn_cnn_kernel_size_list`` with a ReLU between them."""

    def __init__(self, d_ffn, nhead, d_model, dropout=0.0, activation="relu",
                 normalize_before=False, attention_type="regularMHA",
                 ffn_type="regularFFN", ffn_cnn_kernel_size_list=(3, 3),
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.dropout = dropout
        self.self_attn = _make_attention(
            attention_type, d_model, nhead, dropout, **kw
        )
        self.ffn = self.ffn_conv1 = self.ffn_conv2 = None
        if ffn_type == "1dcnn":
            self.ffn_conv1 = Conv1d(
                d_ffn, ffn_cnn_kernel_size_list[0], in_channels=d_model, **kw
            )
            self.ffn_conv2 = Conv1d(
                d_model, ffn_cnn_kernel_size_list[1], in_channels=d_ffn, **kw
            )
        else:
            self.ffn = PositionalwiseFeedForward(
                d_ffn=d_ffn, input_size=d_model, dropout=dropout,
                activation=activation, **kw,
            )
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, cache=None, cache_index=None, anc=None):
        """Full-sequence encode, or KV-cached incremental decode of ONE
        position when ``cache`` ({"self": {"k","v"}}) is given (causal
        decoder-only stacks, e.g. TransformerLM shallow fusion): src is
        (B, 1, D), the step's K/V are written at cache_index, and
        self-attention runs over the cached prefix. Returns (out, cache)
        in cache mode, (out, attention weights) otherwise."""
        src1 = self.norm1(src) if self.normalize_before else src
        if cache is not None:
            out, attn_w, _ = self.self_attn(
                src1, src1, src1, cache=cache["self"],
                cache_index=cache_index, anc=anc,
            )
        else:
            out, attn_w = self.self_attn(
                src1, src1, src1, attn_mask=src_mask,
                key_padding_mask=src_key_padding_mask, pos_embs=pos_embs,
            )
        src = src + F.dropout(out, self.dropout, self.training)
        if not self.normalize_before:
            src = self.norm1(src)
        src1 = self.norm2(src) if self.normalize_before else src
        if self.ffn is None:
            out = self.ffn_conv2(F.relu(self.ffn_conv1(src1)))
        else:
            out = self.ffn(src1)
        src = src + F.dropout(out, self.dropout, self.training)
        if not self.normalize_before:
            src = self.norm2(src)
        if cache is not None:
            return src, cache
        return src, attn_w


class TransformerEncoder(nn.Module):
    """Stack of encoder layers with a final eps-1e-6 LayerNorm, applied
    whether or not the layers are pre-norm.

    ``remat=True`` recomputes each layer in the backward pass
    (:func:`run_layer`). ``layerdrop_prob`` is taken and not read, as in
    the JAX package: no layer is ever dropped."""

    def __init__(self, num_layers, nhead, d_ffn, d_model, dropout=0.0,
                 activation="relu", normalize_before=False,
                 attention_type="regularMHA", layerdrop_prob=0.0,
                 remat=False, ffn_type="regularFFN",
                 ffn_cnn_kernel_size_list=(3, 3), device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.d_model = d_model
        self.remat = remat
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(
                d_ffn=d_ffn, nhead=nhead, d_model=d_model, dropout=dropout,
                activation=activation, normalize_before=normalize_before,
                attention_type=attention_type, ffn_type=ffn_type,
                ffn_cnn_kernel_size_list=ffn_cnn_kernel_size_list,
                device=device, dtype=dtype, generator=generator,
            )
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(d_model, eps=1e-6, device=device, dtype=dtype)

    def forward(self, src, src_mask=None, src_key_padding_mask=None,
                pos_embs=None, cache=None, cache_index=None, anc=None):
        output = src
        attns = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                output, _ = layer(
                    output, cache=cache[i], cache_index=cache_index, anc=anc
                )
            else:
                output, attn = run_layer(
                    layer, self.remat, output, src_mask,
                    src_key_padding_mask, pos_embs,
                )
                attns.append(attn)
        output = self.norm(output)
        if cache is not None:
            return output, cache
        return output, attns

    def init_cache(self, batch_size, max_len, dtype=None):
        """Explicit KV cache for incremental (causal) decoding: one
        {"self": {"k", "v"}} buffer of (B, max_len, d_model) per layer,
        heads MERGED, on the parameters' device. ``max_len`` is rounded up
        to ``CACHE_LENGTH_MULTIPLE``."""
        ref = self.norm.weight
        return _init_cache(
            len(self.layers), batch_size, max_len, self.d_model, ref.device,
            dtype or ref.dtype,
        )


class TransformerDecoderLayer(nn.Module):
    """Causal self-attn + cross-attn + FFN."""

    def __init__(self, d_ffn, nhead, d_model, dropout=0.0, activation="relu",
                 normalize_before=False, attention_type="regularMHA",
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.cross_attn = MultiheadAttention(
            nhead=nhead, d_model=d_model, dropout=dropout, **kw
        )
        self.self_attn = _make_attention(
            attention_type, d_model, nhead, dropout, **kw
        )
        self.ffn = PositionalwiseFeedForward(
            d_ffn=d_ffn, input_size=d_model, dropout=dropout,
            activation=activation, **kw,
        )
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)

    def precompute_cross_kv(self, memory):
        """Project the (static) encoder memory's K/V ONCE; decode steps
        then reuse them through cache["cross"]."""
        return self.cross_attn(memory, memory, memory, return_kv_only=True)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                pos_embs_tgt=None, pos_embs_src=None, cache=None,
                cache_index=None, anc=None):
        """Full-sequence decode, or KV-cached incremental decode of ONE
        position when ``cache`` ({"self": {"k","v"}}) is given: tgt is
        (B, 1, D), the step's projected K/V are written at cache_index,
        and self-attention runs over the cached prefix. Returns (out,
        cache, cross_w) in cache mode, (out, self_w, cross_w) otherwise."""
        tgt1 = self.norm1(tgt) if self.normalize_before else tgt
        if cache is not None:
            out, self_w, _ = self.self_attn(
                tgt1, tgt1, tgt1, cache=cache["self"],
                cache_index=cache_index, anc=anc,
            )
        else:
            out, self_w = self.self_attn(
                tgt1, tgt1, tgt1, attn_mask=tgt_mask,
                key_padding_mask=tgt_key_padding_mask, pos_embs=pos_embs_tgt,
            )
        tgt = tgt + out
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        tgt1 = self.norm2(tgt) if self.normalize_before else tgt
        if cache is not None and cache.get("cross") is not None:
            out, cross_w = self.cross_attn(
                tgt1, memory, memory, attn_mask=memory_mask,
                key_padding_mask=memory_key_padding_mask,
                precomputed_kv=cache["cross"],
            )
        else:
            out, cross_w = self.cross_attn(
                tgt1, memory, memory, attn_mask=memory_mask,
                key_padding_mask=memory_key_padding_mask,
                pos_embs=pos_embs_src,
            )
        tgt = tgt + out
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        tgt1 = self.norm3(tgt) if self.normalize_before else tgt
        tgt = tgt + self.ffn(tgt1)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is not None:
            return tgt, cache, cross_w
        return tgt, self_w, cross_w


class TransformerDecoder(nn.Module):
    """Stack of decoder layers with a final eps-1e-6 LayerNorm."""

    def __init__(self, num_layers, nhead, d_ffn, d_model, dropout=0.0,
                 activation="relu", normalize_before=False,
                 attention_type="regularMHA", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList([
            TransformerDecoderLayer(
                d_ffn=d_ffn, nhead=nhead, d_model=d_model, dropout=dropout,
                activation=activation, normalize_before=normalize_before,
                attention_type=attention_type, device=device, dtype=dtype,
                generator=generator,
            )
            for _ in range(num_layers)
        ])
        self.norm = LayerNorm(d_model, eps=1e-6, device=device, dtype=dtype)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None,
                pos_embs_tgt=None, pos_embs_src=None, cache=None,
                cache_index=None, anc=None):
        """``cache="precompute_cross_kv"`` returns one {"k", "v"} of the
        projected memory per layer and runs nothing else."""
        if isinstance(cache, str):
            if cache != "precompute_cross_kv":
                raise ValueError(f"unknown cache request {cache!r}")
            return [layer.precompute_cross_kv(memory) for layer in self.layers]
        output = tgt
        self_attns, cross_attns = [], []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                output, _, ca = layer(
                    output, memory,
                    memory_key_padding_mask=memory_key_padding_mask,
                    cache=cache[i], cache_index=cache_index, anc=anc,
                )
                sa = None
            else:
                output, sa, ca = layer(
                    output, memory, tgt_mask, memory_mask,
                    tgt_key_padding_mask, memory_key_padding_mask,
                    pos_embs_tgt, pos_embs_src,
                )
            self_attns.append(sa)
            cross_attns.append(ca)
        output = self.norm(output)
        if cache is not None:
            return output, cache, cross_attns
        return output, self_attns, cross_attns

    def init_cache(self, batch_size, max_len, dtype=None):
        """Explicit KV cache for incremental decoding: one
        {"self": {"k", "v"}} buffer of (B, max_len, d_model) per layer
        (heads merged, length rounded up — see
        TransformerEncoder.init_cache)."""
        ref = self.norm.weight
        return _init_cache(
            len(self.layers), batch_size, max_len, self.d_model, ref.device,
            dtype or ref.dtype,
        )
