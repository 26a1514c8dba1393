"""Attention mechanisms (port of ``speechbrain_tpu/nnet/attention.py``):
the seq2seq decoder's ``ContentBasedAttention``,
``LocationAwareAttention`` and ``KeyValueAttention``;
``MultiheadAttention`` in its five call modes, ``PositionalwiseFeedForward``, ``RelPosEncXL``,
``RelPosMHAXL`` and rotary position embeddings (``rope_sincos``,
``apply_rope``, ``RoPEMHA``).

Masks are additive biases built from bool masks (True = masked). In
incremental decoding the K/V cache buffers are updated IN PLACE (the JAX
package, being functional, returns a new cache from
``dynamic_update_slice``); ``cache_index`` is a Python int handed down
from the decode loop.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.ops.attention import flash_attention
from speechbrain_tpu_torch.ops.beam_attention import ancestry_attention

NEG_INF = -1e9  # additive mask value; finite to keep softmax NaN-free


def length_mask(enc_len, T):
    """(B, T) bool, True on the ``round(enc_len * T)`` valid frames of each
    row (relative lengths, rounded half to even as ``jnp.round``)."""
    n = torch.round(enc_len * T)
    return torch.arange(T, device=enc_len.device)[None, :] < n[:, None]


def uniform_attention(enc_len, T, dtype=torch.float32):
    """(B, T) weights spread evenly over each row's valid frames: the
    location-aware attention's ``prev_attn`` before the first step."""
    mask = length_mask(enc_len, T).to(dtype)
    return mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)


def _masked_context(scores, enc_len, values):
    """Softmax of (B, T) scores over the valid frames, and the weighted
    sum of ``values`` (B, T, F)."""
    mask = length_mask(enc_len, scores.shape[1])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    context = torch.einsum("bt,btf->bf", weights, values)
    return context, weights


class ContentBasedAttention(nn.Module):
    """Additive (Bahdanau) attention of one decoder state over the
    encoder states.

    Call with ``(enc_states (B, T, enc_dim), enc_len (B,) relative,
    dec_states (B, dec_dim))``; returns ``(context (B, output_dim),
    weights (B, T))``.

    Example
    -------
    >>> attn = ContentBasedAttention(8, 12, attn_dim=8, output_dim=16,
    ...                              device="cpu")
    >>> ctx, w = attn(torch.ones(2, 10, 8), torch.ones(2), torch.ones(2, 12))
    >>> ctx.shape, w.shape
    (torch.Size([2, 16]), torch.Size([2, 10]))
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim, scaling=1.0,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.scaling = scaling
        self.mlp_enc = Linear(attn_dim, enc_dim, **kw)
        self.mlp_dec = Linear(attn_dim, dec_dim, **kw)
        self.mlp_attn = Linear(1, attn_dim, bias=False, **kw)
        self.mlp_out = Linear(output_dim, enc_dim, **kw)

    def forward(self, enc_states, enc_len, dec_states):
        keys = self.mlp_enc(enc_states)
        query = self.mlp_dec(dec_states)[:, None, :]
        scores = self.mlp_attn(torch.tanh(keys + query))[..., 0]
        context, weights = _masked_context(
            scores * self.scaling, enc_len, enc_states
        )
        return self.mlp_out(context), weights


class LocationAwareAttention(nn.Module):
    """Additive attention with a convolution over the previous step's
    weights added to the score: ``conv_channels`` filters of width
    ``2 * kernel_size + 1``, zero-padded to keep the length, no bias.

    ``prev_attn`` (B, T) is passed in explicitly; None means the first
    step, whose previous weights are uniform over the valid frames.
    Returns ``(context (B, output_dim), weights (B, T))``.

    Example
    -------
    >>> attn = LocationAwareAttention(8, 12, attn_dim=8, output_dim=16,
    ...                               kernel_size=3, device="cpu")
    >>> ctx, w = attn(torch.ones(2, 10, 8), torch.ones(2), torch.ones(2, 12))
    >>> ctx.shape, w.shape
    (torch.Size([2, 16]), torch.Size([2, 10]))
    """

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim,
                 conv_channels=10, kernel_size=100, scaling=1.0,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        from speechbrain_tpu_torch.nnet.CNN import Conv1d

        kw = dict(device=device, dtype=dtype, generator=generator)
        self.scaling = scaling
        self.mlp_enc = Linear(attn_dim, enc_dim, **kw)
        self.mlp_dec = Linear(attn_dim, dec_dim, **kw)
        self.conv_loc = Conv1d(
            out_channels=conv_channels, kernel_size=2 * kernel_size + 1,
            in_channels=1, padding="same", padding_mode="constant",
            bias=False, **kw,
        )
        self.mlp_loc = Linear(attn_dim, conv_channels, **kw)
        self.mlp_attn = Linear(1, attn_dim, bias=False, **kw)
        self.mlp_out = Linear(output_dim, enc_dim, **kw)

    def forward(self, enc_states, enc_len, dec_states, prev_attn=None):
        T = enc_states.shape[1]
        if prev_attn is None:
            prev_attn = uniform_attention(enc_len, T, enc_states.dtype)
        keys = self.mlp_enc(enc_states)
        query = self.mlp_dec(dec_states)[:, None, :]
        loc = self.mlp_loc(self.conv_loc(prev_attn[..., None]))
        scores = self.mlp_attn(torch.tanh(keys + query + loc))[..., 0]
        context, weights = _masked_context(
            scores * self.scaling, enc_len, enc_states
        )
        return self.mlp_out(context), weights


class KeyValueAttention(nn.Module):
    """Scaled dot-product attention of one decoder state over the
    encoder states, with separate key, value and query projections.
    Returns ``(context (B, output_dim), weights (B, T))``."""

    def __init__(self, enc_dim, dec_dim, attn_dim, output_dim,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.attn_dim = attn_dim
        self.key_linear = Linear(attn_dim, enc_dim, **kw)
        self.value_linear = Linear(output_dim, enc_dim, **kw)
        self.query_linear = Linear(attn_dim, dec_dim, **kw)

    def forward(self, enc_states, enc_len, dec_states):
        keys = self.key_linear(enc_states)
        values = self.value_linear(enc_states)
        query = self.query_linear(dec_states)
        scores = torch.einsum("bta,ba->bt", keys, query) / math.sqrt(
            self.attn_dim
        )
        return _masked_context(scores, enc_len, values)


def scaled_dot_product_attention(q, k, v, mask_bias=None, dropout_rate=0.0,
                                 training=False, use_pallas=False):
    """Core softmax(QK^T/sqrt(d) + bias)V on (B, H, T, D) tensors, written
    out so that the attention weights can be returned.

    ``mask_bias`` is additive, broadcastable to (B, H, Tq, Tk).
    ``use_pallas=True`` (the JAX package's name for it) runs the fused
    flash-attention kernel instead (``ops/attention.py``) and returns
    ``(out, None)``: the weights are not materialised, and attention
    dropout is not applied, so it refuses a training call with dropout.
    The kernel has no backward either: on inputs that require grad it
    raises (``ops.refuse_autograd``).
    """
    if use_pallas:
        if training and dropout_rate > 0.0:
            raise ValueError(
                "the flash attention kernel applies no dropout; use "
                "use_pallas=False to train with attention dropout"
            )
        return flash_attention(q, k, v, mask_bias)
    d = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    if mask_bias is not None:
        scores = scores + mask_bias
    weights = torch.softmax(scores, dim=-1)
    weights = F.dropout(weights, dropout_rate, training)
    return torch.matmul(weights, v), weights


def make_mask_bias(key_padding_mask=None, attn_mask=None,
                   dtype=torch.float32):
    """Combine key-padding (B, Tk) bool and attention (Tq, Tk) or
    (B, Tq, Tk) bool masks (True = masked) into an additive bias."""
    bias = None
    if key_padding_mask is not None:
        bias = torch.zeros(
            key_padding_mask.shape, dtype=dtype,
            device=key_padding_mask.device,
        ).masked_fill_(key_padding_mask, NEG_INF)[:, None, None, :]
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            a = torch.zeros(
                attn_mask.shape, dtype=dtype, device=attn_mask.device
            ).masked_fill_(attn_mask, NEG_INF)
        else:
            a = attn_mask.to(dtype)
        if a.ndim == 2:  # (Tq, Tk)
            a = a[None, None]
        elif a.ndim == 3:  # (B, Tq, Tk): batch-wise, broadcast over heads
            a = a[:, None]
        bias = a if bias is None else bias + a
    return bias


class MultiheadAttention(nn.Module):
    """Standard MHA: call (query, key, value, attn_mask, key_padding_mask,
    pos_embs) -> (output, weights). The four projections stay separate.

    ``use_pallas=True`` sends the standard call through the flash-attention
    kernel, which returns no weights: the call then gives (output, None).
    The cached, ancestry and ``precomputed_kv`` arms never use it.

    Example
    -------
    >>> mha = MultiheadAttention(nhead=4, d_model=32, device="cpu")
    >>> x = torch.ones(2, 10, 32)
    >>> out, w = mha(x, x, x)
    >>> out.shape
    torch.Size([2, 10, 32])
    """

    def __init__(self, nhead, d_model, dropout=0.0, use_pallas=False,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("d_model must be a multiple of nhead")
        self.nhead = nhead
        self.d_model = d_model
        self.dropout = dropout
        self.use_pallas = use_pallas
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(d_model, d_model, **kw)
        self.k_proj = Linear(d_model, d_model, **kw)
        self.v_proj = Linear(d_model, d_model, **kw)
        self.out_proj = Linear(d_model, d_model, **kw)

    def _heads(self, x):
        """(B, T, D) -> head-major (B, H, T, hd)."""
        B, T, _ = x.shape
        return x.reshape(
            B, T, self.nhead, self.d_model // self.nhead
        ).transpose(1, 2)

    def _merge(self, x):
        """(B, H, T, hd) -> (B, T, D)."""
        B, _, T, _ = x.shape
        return x.transpose(1, 2).reshape(B, T, self.d_model)

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, pos_embs=None, cache=None,
                cache_index=None, precomputed_kv=None, return_kv_only=False,
                anc=None):
        """Standard call, or INCREMENTAL-DECODE call when ``cache`` is
        given: query is the new step (B, 1, D); the projected K/V of that
        step are written into the cache {"k": (B, L, D), "v": ...} at
        ``cache_index`` (in place) and attention runs over the valid
        prefix only. Returns (out, weights, cache) in cache mode.

        Serving fast paths: ``return_kv_only=True`` projects key/value
        once and returns {"k": (B, H, Tk, hd), "v": ...};
        ``precomputed_kv`` feeds that result back so cross-attention in a
        decode loop never re-projects the (static) encoder states."""
        B, Tq, _ = query.shape
        hd = self.d_model // self.nhead
        if return_kv_only:
            # stored HEAD-MAJOR (B, H, Tk, hd): the decode loop consumes
            # them in this layout every step, so the transpose happens
            # once here instead of once per generated token
            return {
                "k": self._heads(self.k_proj(key)).contiguous(),
                "v": self._heads(self.v_proj(value)).contiguous(),
            }
        q = self.q_proj(query)
        if precomputed_kv is not None:
            kc = precomputed_kv["k"]  # (kv_b, H, Tk, hd), head-major
            vc = precomputed_kv["v"]
            kv_b = kc.shape[0]
            if kv_b != B:
                # beam-SHARED K/V: the kv batch holds one entry per
                # utterance while queries are beam-inflated (B = kv_b *
                # beams). Group the beams into the query-time axis so the
                # encoder K/V are never replicated per beam.
                G = B // kv_b
                qg = q.reshape(kv_b, G * Tq, self.nhead, hd).transpose(1, 2)
                bias = make_mask_bias(
                    None if key_padding_mask is None
                    else key_padding_mask.reshape(kv_b, G, -1)[:, 0],
                    attn_mask, q.dtype,
                )
                out, w = scaled_dot_product_attention(qg, kc, vc, bias)
                out = out.transpose(1, 2).reshape(B, Tq, self.d_model)
                return self.out_proj(out), w.mean(dim=1).reshape(B, Tq, -1)
            bias = make_mask_bias(key_padding_mask, attn_mask, q.dtype)
            out, w = scaled_dot_product_attention(
                self._heads(q), kc, vc, bias
            )
            return self.out_proj(self._merge(out)), w.mean(dim=1)
        k = self.k_proj(key)
        v = self.v_proj(value)
        if cache is not None:
            # Tq == 1 incremental decode over cache buffers that keep the
            # heads MERGED, (B, L, d_model). The step's K/V are written in
            # place; the caller's cache dict is returned as it is.
            cache["k"][:, cache_index] = k[:, 0]
            cache["v"][:, cache_index] = v[:, 0]
            L = cache["k"].shape[1]
            if anc is not None:
                # ancestry beam decoding: cache rows NEVER move; the
                # (B_utt, K, L) ancestry table says which beam row holds
                # each position of each hypothesis' history, and the
                # kernel selects during attention — no per-step cache
                # permute (ops/beam_attention.py)
                B_utt, Kb = anc.shape[0], anc.shape[1]
                out = ancestry_attention(
                    q.reshape(B_utt, Kb, self.nhead, hd),
                    cache["k"].view(B_utt, Kb, L, self.d_model),
                    cache["v"].view(B_utt, Kb, L, self.d_model),
                    anc, cache_index,
                )
                out = out.reshape(B, Tq, self.d_model)
                return self.out_proj(out), None, cache
            ck = cache["k"].view(B, L, self.nhead, hd)
            cv = cache["v"].view(B, L, self.nhead, hd)
            qh = q.reshape(B, Tq, self.nhead, hd).float()
            qh = qh * (1.0 / math.sqrt(hd))
            # scores (B, L, H): multiply broadcast over L, reduce hd
            scores = torch.sum(qh * ck.float(), dim=-1)
            # causal prefix: only cached positions <= cache_index attend
            valid = torch.arange(L, device=q.device) <= cache_index
            scores = torch.where(valid[None, :, None], scores, NEG_INF)
            w = torch.softmax(scores, dim=1)  # (B, L, H)
            out = torch.sum(w[..., None] * cv.float(), dim=1)  # (B, H, hd)
            out = out.to(query.dtype).reshape(B, Tq, self.d_model)
            return self.out_proj(out), w.mean(dim=-1)[:, None, :], cache
        bias = make_mask_bias(key_padding_mask, attn_mask, q.dtype)
        if pos_embs is not None:
            # additive positional bias (B or 1, Tq, Tk)
            pe = pos_embs
            while pe.ndim < 4:
                pe = pe[None]
            bias = pe if bias is None else bias + pe
        out, w = scaled_dot_product_attention(
            self._heads(q), self._heads(k), self._heads(v), bias,
            self.dropout, self.training, self.use_pallas,
        )
        out = self.out_proj(self._merge(out))
        return out, (None if w is None else w.mean(dim=1))


class PositionalwiseFeedForward(nn.Module):
    """Transformer FFN: Linear -> activation -> dropout -> Linear."""

    def __init__(self, d_ffn, input_size, dropout=0.0, activation="relu",
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ffn1 = Linear(d_ffn, input_size, **kw)
        self.ffn2 = Linear(input_size, d_ffn, **kw)
        self.act = get_activation(activation)
        self.dropout = dropout

    def forward(self, x):
        y = self.act(self.ffn1(x))
        y = F.dropout(y, self.dropout, self.training)
        return self.ffn2(y)


# ---------------------------------------------------------------------------
# Relative positional encoding (Transformer-XL style, used by Conformer)
# ---------------------------------------------------------------------------

def rel_pos_encoding(T, d):
    """Sinusoidal embeddings (1, 2T-1, d), numpy float32, for relative
    positions T-1 .. -(T-1).

    Both halves encode the |distance| — the future half reuses the past
    sinusoids (sin(|p|f), cos(|p|f)), so direction information comes from
    the learned pos_bias_u/v and the rel-shift, not the embedding sign."""
    pos = np.abs(np.arange(T - 1, -T, -1, dtype=np.float32))[:, None]
    inv_freq = np.exp(
        np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d)
    )
    pe = np.zeros((2 * T - 1, d), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * inv_freq)
    pe[:, 1::2] = np.cos(pos * inv_freq)
    return pe[None]


class RelPosEncXL(nn.Module):
    """Produce relative positional embeddings (1, 2T-1, d) on the device
    and in the dtype of the input."""

    def __init__(self, emb_dim):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, x):
        pe = rel_pos_encoding(x.shape[1], self.emb_dim)
        # non_blocking: the host array is staged at once, and the upload
        # does not wait for the device's queue
        return torch.from_numpy(pe).to(device=x.device, dtype=x.dtype,
                                       non_blocking=True)


def _rel_shift(x):
    """(B, H, Tq, 2Tk-1) -> (B, H, Tq, Tk) Transformer-XL relative shift."""
    B, H, Tq, L = x.shape
    Tk = (L + 1) // 2
    x = F.pad(x, (1, 0))
    x = x.reshape(B, H, L + 1, Tq)
    x = x[:, :, 1:, :].reshape(B, H, Tq, L)
    return x[..., :Tk]


class RelPosMHAXL(nn.Module):
    """Multi-head attention with Transformer-XL relative position bias —
    the Conformer's MHSA.

    Call (query, key, value, attn_mask, key_padding_mask, pos_embs) where
    pos_embs is RelPosEncXL output (1, 2Tk-1, d).
    """

    def __init__(self, embed_dim, num_heads, dropout=0.0, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.pos_proj = Linear(embed_dim, embed_dim, bias=False, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        hd = embed_dim // num_heads
        self.pos_bias_u = nn.Parameter(
            torch.zeros(num_heads, hd, device=device, dtype=dtype)
        )
        self.pos_bias_v = nn.Parameter(
            torch.zeros(num_heads, hd, device=device, dtype=dtype)
        )

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, pos_embs=None):
        B, Tq, _ = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        hd = self.embed_dim // H
        q = self.q_proj(query).reshape(B, Tq, H, hd)
        k = self.k_proj(key).reshape(B, Tk, H, hd)
        v = self.v_proj(value).reshape(B, Tk, H, hd)
        if pos_embs is None:
            pos_embs = torch.from_numpy(
                rel_pos_encoding(Tk, self.embed_dim)
            ).to(device=q.device, dtype=q.dtype, non_blocking=True)
        p = self.pos_proj(pos_embs).reshape(-1, H, hd)  # (2Tk-1, H, hd)

        q_u = (q + self.pos_bias_u).transpose(1, 2)  # (B, H, Tq, hd)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        content = torch.matmul(q_u, k.permute(0, 2, 3, 1))  # (B,H,Tq,Tk)
        pos = torch.matmul(q_v, p.permute(1, 2, 0))  # (B, H, Tq, 2Tk-1)
        pos = _rel_shift(pos)
        # scaled by 1/sqrt(embed_dim), NOT 1/sqrt(head_dim), as the JAX
        # package (and upstream SpeechBrain) do
        scores = (content + pos) / math.sqrt(self.embed_dim)
        bias = make_mask_bias(key_padding_mask, attn_mask, scores.dtype)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores, dim=-1)
        weights = F.dropout(weights, self.dropout, self.training)
        out = torch.matmul(weights, v.transpose(1, 2))  # (B, H, Tq, hd)
        out = out.transpose(1, 2).reshape(B, Tq, self.embed_dim)
        return self.out_proj(out), weights.mean(dim=1)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_sincos(T, dim, base=10000.0):
    """RoPE (sin, cos) tables (T, dim/2) as numpy float32 arrays."""
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(T, dtype=np.float32)[:, None]
    ang = t * inv_freq[None, :]
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def apply_rope(x, sin, cos, offset=0):
    """Rotate the INTERLEAVED channel pairs (0, 1), (2, 3), ... of
    (B, T, H, D) ``x`` by the angles of positions ``offset`` to
    ``offset + T`` (tables (>= offset + T, D/2) on x's device)."""
    T = x.shape[1]
    sin_t = sin[offset: offset + T][None, :, None, :].to(x.dtype)
    cos_t = cos[offset: offset + T][None, :, None, :].to(x.dtype)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    rot1 = x1 * cos_t - x2 * sin_t
    rot2 = x2 * cos_t + x1 * sin_t
    return torch.stack([rot1, rot2], dim=-1).reshape(x.shape)


class RoPEMHA(nn.Module):
    """Multi-head attention with rotary position embeddings on queries and
    keys (both indexed from position 0), the RoPE-Conformer's MHSA. Returns
    (output, weights averaged over heads).

    The tables span ``max(max_len, Tk)`` positions; they are built once per
    length and device and kept.

    Example
    -------
    >>> mha = RoPEMHA(nhead=4, d_model=32, device="cpu")
    >>> x = torch.ones(2, 10, 32)
    >>> out, w = mha(x, x, x)
    >>> out.shape, w.shape
    (torch.Size([2, 10, 32]), torch.Size([2, 10, 10]))
    """

    def __init__(self, nhead, d_model, dropout=0.0, max_len=8192,
                 rope_base=10000.0, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError("d_model must be a multiple of nhead")
        self.nhead = nhead
        self.d_model = d_model
        self.dropout = dropout
        self.max_len = max_len
        self.rope_base = rope_base
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q_proj = Linear(d_model, d_model, **kw)
        self.k_proj = Linear(d_model, d_model, **kw)
        self.v_proj = Linear(d_model, d_model, **kw)
        self.out_proj = Linear(d_model, d_model, **kw)
        self._tables = {}

    def _sincos(self, T, device):
        key = (T, str(device))
        if key not in self._tables:
            sin, cos = rope_sincos(
                T, self.d_model // self.nhead, self.rope_base
            )
            self._tables[key] = (
                torch.from_numpy(sin).to(device),
                torch.from_numpy(cos).to(device),
            )
        return self._tables[key]

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, pos_embs=None):
        B, Tq, _ = query.shape
        Tk = key.shape[1]
        H, hd = self.nhead, self.d_model // self.nhead
        sin, cos = self._sincos(max(self.max_len, Tk), query.device)
        q = self.q_proj(query).reshape(B, Tq, H, hd)
        k = self.k_proj(key).reshape(B, Tk, H, hd)
        v = self.v_proj(value).reshape(B, Tk, H, hd)
        q = apply_rope(q, sin, cos).transpose(1, 2)
        k = apply_rope(k, sin, cos).transpose(1, 2)
        bias = make_mask_bias(key_padding_mask, attn_mask, q.dtype)
        out, w = scaled_dot_product_attention(
            q, k, v.transpose(1, 2), bias, self.dropout, self.training
        )
        out = out.transpose(1, 2).reshape(B, Tq, self.d_model)
        return self.out_proj(out), w.mean(dim=1)
