"""Encoder-decoder Transformer/Conformer ASR wrapper and its
``EncoderWrapper`` (port of
``speechbrain_tpu/lobes/models/transformer/TransformerASR.py``): joins an
input projection, a Transformer, Conformer or Branchformer encoder and a
Transformer decoder, building the padding, causal and chunked masks from
relative lengths and a dynamic chunk configuration.

Positions: with ``RelPosMHAXL`` the encoder reads relative position
embeddings and the source gets no absolute encoding; with any other
attention (``RoPEMHA`` and ``hypermixing`` included) the absolute sine
encoding is added to the source, as in the JAX package.

Streaming (Conformer encoders): ``encode_streaming`` encodes one chunk
with the state ``make_streaming_context`` starts, and equals ``encode``
with the same ``dynchunktrain_config`` over the concatenated chunks. The
JAX package's departs from it twice: in the convolution module
(``Conformer.py``, ROADMAP.md C34) and, for an encoder without
``RelPosMHAXL``, in the absolute position encoding, which it restarts at
every chunk (C36).
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.Branchformer import (
    BranchformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerEncoder,
    make_chunked_attention_mask,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    NormalizedEmbedding,
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    get_key_padding_mask,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL
from speechbrain_tpu_torch.nnet.linear import Linear


def make_transformer_src_mask(src, dynchunktrain_config=None):
    """(T, T) bool attention mask of the encoder, True where masked: None
    for full context, chunked for a dynamic chunk configuration."""
    if dynchunktrain_config is None:
        return None
    return make_chunked_attention_mask(
        src.shape[1], dynchunktrain_config.chunk_size,
        dynchunktrain_config.left_context_size, device=src.device,
    )


def make_transformer_src_tgt_masks(src, tgt=None, wav_len=None, pad_idx=0,
                                   dynchunktrain_config=None):
    """The masks used by forward: (src_key_padding_mask,
    tgt_key_padding_mask, src_mask, tgt_mask)."""
    src_key_padding_mask = None
    if wav_len is not None:
        src_key_padding_mask = get_key_padding_mask(wav_len, src.shape[1])
    src_mask = make_transformer_src_mask(src, dynchunktrain_config)
    tgt_key_padding_mask = None
    tgt_mask = None
    if tgt is not None:
        tgt_key_padding_mask = tgt == pad_idx
        tgt_mask = get_lookahead_mask(tgt.shape[1], tgt.device)
    return src_key_padding_mask, tgt_key_padding_mask, src_mask, tgt_mask


class TransformerASR(nn.Module):
    """Encoder-decoder ASR transformer.

    Inputs: src (B, T, F) features (or (B,T,F,C), flattened), tgt (B, U)
    token ids. ``forward`` returns (encoder_out, decoder_out);
    ``encode``/``decode`` run the halves separately (for CTC-only or beam
    search); ``decode_step`` is the KV-cached serving step.

    Example
    -------
    >>> net = TransformerASR(tgt_vocab=40, input_size=40, d_model=32,
    ...     nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=64,
    ...     device="cpu").eval()
    >>> src = torch.ones(2, 16, 40); tgt = torch.ones(2, 5, dtype=torch.long)
    >>> enc, dec = net(src, tgt)
    >>> enc.shape, dec.shape
    (torch.Size([2, 16, 32]), torch.Size([2, 5, 32]))
    """

    def __init__(self, tgt_vocab, input_size, d_model=512, nhead=8,
                 num_encoder_layers=6, num_decoder_layers=6, d_ffn=2048,
                 dropout=0.1, activation="relu",
                 positional_encoding="fixed_abs_sine", normalize_before=False,
                 kernel_size=31, bias=True, encoder_module="transformer",
                 attention_type="regularMHA", max_length=2500, causal=False,
                 encoder_remat=False, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.d_model = d_model
        self.attention_type = attention_type
        self.encoder_module = encoder_module
        self.custom_src_module = Linear(d_model, input_size, **kw)
        # no decoder, no target embedding (the JAX module's tree has none)
        self.custom_tgt_module = NormalizedEmbedding(
            d_model=d_model, vocab=tgt_vocab, **kw
        ) if num_decoder_layers > 0 else None
        if attention_type == "RelPosMHAXL":
            self.pos_enc = RelPosEncXL(emb_dim=d_model)
        elif positional_encoding == "fixed_abs_sine":
            self.pos_enc = PositionalEncoding(
                input_size=d_model, max_len=max_length, device=device
            )
        else:
            self.pos_enc = None
        if encoder_module == "conformer":
            self.encoder = ConformerEncoder(
                num_layers=num_encoder_layers, d_model=d_model, d_ffn=d_ffn,
                nhead=nhead, kernel_size=kernel_size, bias=bias,
                dropout=dropout, causal=causal,
                attention_type=attention_type, remat=encoder_remat, **kw,
            )
        elif encoder_module == "branchformer":
            # the JAX package does not hand encoder_remat to its
            # branchformer (ROADMAP.md C27); values are the same either way
            self.encoder = BranchformerEncoder(
                num_layers=num_encoder_layers, d_model=d_model, nhead=nhead,
                kernel_size=kernel_size, attention_type=attention_type,
                csgu_linear_units=d_ffn, dropout=dropout,
                remat=encoder_remat, **kw,
            )
        elif encoder_module == "transformer":
            self.encoder = TransformerEncoder(
                num_layers=num_encoder_layers, nhead=nhead, d_ffn=d_ffn,
                d_model=d_model, dropout=dropout, activation=activation,
                normalize_before=normalize_before,
                attention_type=attention_type, remat=encoder_remat, **kw,
            )
        else:
            raise ValueError(f"Unknown encoder_module {encoder_module}")
        self.decoder = None
        if num_decoder_layers > 0:
            self.decoder = TransformerDecoder(
                num_layers=num_decoder_layers, nhead=nhead, d_ffn=d_ffn,
                d_model=d_model, dropout=dropout, activation=activation,
                normalize_before=normalize_before,
                attention_type="regularMHA", **kw,
            )
        # decoder uses absolute positions even with RelPos encoder
        self.pos_enc_dec = PositionalEncoding(
            input_size=d_model, max_len=max_length, device=device
        )

    def _embed_src(self, src, offset=0):
        """The projected source and its relative position embeddings (or
        None); an absolute encoding is added from position ``offset``."""
        if src.ndim == 4:
            B, T, Fdim, C = src.shape
            src = src.reshape(B, T, Fdim * C)
        src = self.custom_src_module(src)
        pos_embs = None
        if self.attention_type == "RelPosMHAXL":
            pos_embs = self.pos_enc(src)
        elif self.pos_enc is not None:
            src = src + self.pos_enc(src, offset)
        return src, pos_embs

    def _encode(self, src, src_mask, src_key_padding_mask, pos_embs,
                dynchunktrain_config=None):
        # a branchformer has no attention mask (full context)
        if self.encoder_module == "branchformer":
            return self.encoder(
                src, src_key_padding_mask=src_key_padding_mask,
                pos_embs=pos_embs,
            )
        # only the Conformer's convolution takes the chunks
        extra = ({"dynchunktrain_config": dynchunktrain_config}
                 if self.encoder_module == "conformer" else {})
        return self.encoder(
            src, src_mask=src_mask,
            src_key_padding_mask=src_key_padding_mask, pos_embs=pos_embs,
            **extra,
        )

    def _memory_mask(self, encoder_out, enc_len):
        if enc_len is None:
            return None
        return get_key_padding_mask(enc_len, encoder_out.shape[1])

    def encode(self, src, wav_len=None, pad_idx=0, dynchunktrain_config=None):
        """Encoder half: (B, T, F) -> (B, T, d_model); chunked attention
        and convolution under a dynamic chunk configuration."""
        src, pos_embs = self._embed_src(src)
        src_key_padding_mask, _, src_mask, _ = make_transformer_src_tgt_masks(
            src, None, wav_len, pad_idx, dynchunktrain_config
        )
        enc_out, _ = self._encode(
            src, src_mask, src_key_padding_mask, pos_embs,
            dynchunktrain_config,
        )
        return enc_out

    def make_streaming_context(self, batch, dynchunktrain_config):
        """The state before a stream's first chunk, for
        ``encode_streaming``: a dict of the encoder's
        ``ConformerEncoderStreamingContext`` (``"encoder"``) and the frames
        streamed so far (``"frames"``). ``batch`` is the JAX package's
        argument; the port's state takes its batch from the first
        chunk."""
        if self.encoder_module != "conformer":
            raise ValueError("streaming needs a Conformer encoder")
        return {"encoder": self.encoder.make_streaming_context(
            dynchunktrain_config), "frames": 0}

    def encode_streaming(self, src, context):
        """One chunk of features (B, T, F) -> (its encoder states (B, T,
        d_model), ``context``, updated in place). An absolute position
        encoding goes on at the chunk's place in the stream, as the
        offline encode adds it (a stream then ends at ``max_length``
        frames); the JAX package restarts it at every chunk (ROADMAP.md
        C36)."""
        src, _ = self._embed_src(src, offset=context["frames"])
        context["frames"] += src.shape[1]
        enc_out = self.encoder.forward_streaming(src, context["encoder"])
        return enc_out, context

    def decode(self, tgt, encoder_out, enc_len=None):
        """Decoder half for beam search: returns (decoder_out, cross_attn
        of last layer)."""
        emb = self.custom_tgt_module(tgt)
        emb = emb + self.pos_enc_dec(emb)
        out, _, cross_attns = self.decoder(
            emb, encoder_out,
            tgt_mask=get_lookahead_mask(tgt.shape[1], tgt.device),
            memory_key_padding_mask=self._memory_mask(encoder_out, enc_len),
        )
        return out, cross_attns[-1]

    def init_decoder_cache(self, batch_size, max_len, dtype=None):
        """Explicit per-layer KV buffers for incremental decoding
        (decode_step)."""
        return self.decoder.init_cache(batch_size, max_len, dtype)

    def init_decoder_cache_with_cross(self, encoder_out, max_len,
                                      self_batch=None, dtype=None):
        """Decode cache with the cross-attention K/V of every layer
        PRECOMPUTED from the encoder states: decode_step then skips the
        per-step re-projection of the (static) memory.

        For beam search, pass the UNINFLATED encoder states with
        ``self_batch=batch*beam``: the cross K/V stay one-per-utterance
        (the attention broadcasts them over the beams) while the
        per-hypothesis self K/V buffers are allocated at batch*beam."""
        cross = self.decoder(None, encoder_out, cache="precompute_cross_kv")
        cache = self.decoder.init_cache(
            self_batch or encoder_out.shape[0], max_len, dtype
        )
        return [
            {"self": c["self"], "cross": x} for c, x in zip(cache, cross)
        ]

    def decode_step(self, tgt_tokens, encoder_out, cache, step, enc_len=None,
                    anc=None):
        """KV-cached decode of ONE token: tgt_tokens (B,) just consumed ->
        (decoder out (B, D), cache, last cross-attn). ``step`` is a Python
        int; the cache's self buffers are written in place."""
        emb = self.custom_tgt_module(tgt_tokens[:, None])  # (B, 1, D)
        emb = emb + self.pos_enc_dec.at(step, emb.dtype)
        out, cache, cross_attns = self.decoder(
            emb, encoder_out,
            memory_key_padding_mask=self._memory_mask(encoder_out, enc_len),
            cache=cache, cache_index=step, anc=anc,
        )
        return out[:, 0], cache, cross_attns[-1]

    def forward(self, src, tgt, wav_len=None, pad_idx=0,
                dynchunktrain_config=None):
        src_proj, pos_embs = self._embed_src(src)
        (
            src_key_padding_mask,
            tgt_key_padding_mask,
            src_mask,
            tgt_mask,
        ) = make_transformer_src_tgt_masks(src_proj, tgt, wav_len, pad_idx,
                                           dynchunktrain_config)
        enc_out, _ = self._encode(
            src_proj, src_mask, src_key_padding_mask, pos_embs,
            dynchunktrain_config,
        )
        if self.decoder is None or tgt is None:
            return enc_out, None
        emb = self.custom_tgt_module(tgt)
        emb = emb + self.pos_enc_dec(emb)
        dec_out, _, _ = self.decoder(
            emb, enc_out, tgt_mask=tgt_mask,
            tgt_key_padding_mask=tgt_key_padding_mask,
            memory_key_padding_mask=src_key_padding_mask,
        )
        return enc_out, dec_out


class EncoderWrapper(nn.Module):
    """The encoder of a ``TransformerASR`` alone, as ``(x, lengths) ->
    encoder states``, so that a ``nnet/containers.LengthsCapableSequential``
    can end in it (CTC-only models, served encoders).

    Example
    -------
    >>> net = TransformerASR(tgt_vocab=8, input_size=12, d_model=16,
    ...     nhead=2, num_encoder_layers=1, num_decoder_layers=0, d_ffn=32,
    ...     device="cpu").eval()
    >>> EncoderWrapper(net)(torch.ones(2, 10, 12), torch.ones(2)).shape
    torch.Size([2, 10, 16])
    """

    def __init__(self, transformer):
        super().__init__()
        self.transformer = transformer

    def forward(self, x, lengths=None, dynchunktrain_config=None):
        return self.transformer.encode(
            x, wav_len=lengths, dynchunktrain_config=dynchunktrain_config)
