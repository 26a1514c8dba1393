"""Decoder-only Transformer language model (port of
``speechbrain_tpu/lobes/models/transformer/TransformerLM.py``): token
embedding + causal self-attention encoder stack + output head, returning
logits for shallow fusion / rescoring.
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerEncoder,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import LayerNorm


class TransformerLM(nn.Module):
    """Causal transformer LM: (B, U) ids -> (B, U, vocab) logits.

    Example
    -------
    >>> lm = TransformerLM(vocab=100, d_model=32, nhead=4,
    ...     num_encoder_layers=2, d_ffn=64, device="cpu").eval()
    >>> lm(torch.ones(2, 7, dtype=torch.long)).shape
    torch.Size([2, 7, 100])
    """

    def __init__(self, vocab, d_model=768, nhead=12, num_encoder_layers=12,
                 d_ffn=3072, dropout=0.0, activation="gelu",
                 normalize_before=False, d_embedding=None,
                 attention_type="regularMHA", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = d_model
        emb_dim = d_embedding or d_model
        self.emb = NormalizedEmbedding(d_model=emb_dim, vocab=vocab, **kw)
        self.emb_proj = (
            Linear(d_model, emb_dim, **kw) if emb_dim != d_model else None
        )
        self.pos = PositionalEncoding(input_size=d_model, device=device)
        self.encoder = TransformerEncoder(
            num_layers=num_encoder_layers, nhead=nhead, d_ffn=d_ffn,
            d_model=d_model, dropout=dropout, activation=activation,
            normalize_before=normalize_before,
            attention_type=attention_type, **kw,
        )
        # output head: Linear -> LayerNorm(eps 1e-6) -> Linear
        self.out_proj = Linear(d_model, d_model, **kw)
        self.out_norm = LayerNorm(
            d_model, eps=1e-6, device=device, dtype=dtype
        )
        self.out = Linear(vocab, d_model, **kw)

    def _embed(self, x):
        emb = self.emb(x)
        if self.emb_proj is not None:
            emb = self.emb_proj(emb)
        return emb

    def _head(self, x):
        return self.out(self.out_norm(self.out_proj(x)))

    def forward(self, x):
        emb = self._embed(x)
        emb = emb + self.pos(emb)
        mask = get_lookahead_mask(x.shape[1], x.device)
        out, _ = self.encoder(emb, src_mask=mask)
        return self._head(out)

    def embed_tokens(self, ids):
        """Token ids -> model-space embeddings (the hook through which a
        caller puts other embeddings, audio for one, in the same space)."""
        return self._embed(ids)

    def forward_embeds(self, embeds):
        """The causal LM over a PRE-EMBEDDED sequence (B, T, d_model) ->
        (B, T, vocab) logits, for a stream the caller has put together
        from ``embed_tokens`` and other embeddings."""
        emb = embeds + self.pos(embeds)
        mask = get_lookahead_mask(embeds.shape[1], embeds.device)
        out, _ = self.encoder(emb, src_mask=mask)
        return self._head(out)

    def init_cache(self, batch_size, max_len, dtype=None):
        """Per-layer KV buffers for incremental scoring (score_step)."""
        return self.encoder.init_cache(batch_size, max_len, dtype)

    def score_step(self, tokens, cache, step, anc=None):
        """KV-cached scoring of ONE token: tokens (B,) just consumed ->
        (next-token logits (B, vocab), cache). ``step`` is a Python int;
        the cache is written in place."""
        emb = self._embed(tokens[:, None])  # (B, 1, D)
        emb = emb + self.pos.at(step, emb.dtype)
        out, cache = self.encoder(
            emb, cache=cache, cache_index=step, anc=anc
        )
        return self._head(out[:, 0]), cache
