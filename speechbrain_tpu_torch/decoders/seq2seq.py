"""Sequence-to-sequence decoding: greedy and batched beam search (port of
``speechbrain_tpu/decoders/seq2seq.py`` without its Whisper searchers).

The JAX package compiles a search into one ``lax.while_loop``; here it
is a Python loop over decode steps with the same early exit, and ``step``
is a Python int handed to the model. Hypothesis memories (decoder KV /
scorer state) are nested dicts and lists of tensors with leading dim
``batch*beam``, permuted by predecessor gather — or, with ancestry
decoding, never moved at all.

Subclasses adapt concrete models by implementing ``reset_mem`` /
``forward_step`` / ``permute_mem``.
"""

import numpy as np
import torch

from speechbrain_tpu_torch.decoders.permute import gather_tree
from speechbrain_tpu_torch.decoders.utils import (
    inflate_tensor,
    top_k_lowest_index,
)
from speechbrain_tpu_torch.ops.gather import gather_pytree


def cache_length(cache):
    """Length (axis 1) of the per-hypothesis self-attention buffers of a
    per-layer KV cache (beam-shared "cross" entries have another shape)."""
    return cache[0]["self"]["k"].shape[1]


def init_ancestry(n_utt, beam, length, device):
    """Ancestry table (n_utt, beam, length) int32 with every entry set to
    its own beam row: ``anc[b, h, t]`` is the beam row that holds position
    ``t`` of hypothesis ``h``'s history."""
    own = torch.arange(beam, dtype=torch.int32, device=device)
    return own[None, :, None].expand(n_utt, beam, length).contiguous()


def _stamp_self_column(anc, step):
    """Set ancestry column ``step`` to each hypothesis' own row id (the
    row that writes position ``step`` this decode step). Written in place
    and returned."""
    K = anc.shape[1]
    anc[:, :, step] = torch.arange(K, dtype=anc.dtype, device=anc.device)
    return anc


def permute_ancestry(anc, index):
    """Predecessor gather of the ancestry table by flat batch*beam rows."""
    B, K, L = anc.shape
    return anc.reshape(B * K, L).index_select(0, index).reshape(B, K, L)


def _materialize(leaf, n_bh):
    """A tensor leaf with a leading dim of 1 broadcast to ``n_bh`` rows (a
    copy, so that the rows can be written and gathered apart); other
    leaves as they are."""
    if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
            and leaf.shape[0] == 1 and n_bh > 1):
        return leaf.expand(n_bh, *leaf.shape[1:]).contiguous()
    return leaf


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _materialize_mem(mem, n_bh):
    """The search's initial memory with every leading-dim-1 tensor
    broadcast to ``batch * beam`` = ``n_bh`` rows, so that the predecessor
    gather along axis 0 finds a row for every hypothesis. Exempt: the
    beam-shared ``"cross"`` entries of a per-layer cache (never permuted;
    at batch 1 their leading dim of 1 is the per-utterance layout), and
    in ancestry mode the ``"anc"`` table (already ``(B, K, L)``; only the
    wrapped ``"cache"`` is materialized)."""
    if isinstance(mem, (list, tuple)) and all(
            isinstance(layer, dict) for layer in mem):
        return [
            {k: (v if k == "cross"
                 else _map_leaves(v, lambda t: _materialize(t, n_bh)))
             for k, v in layer.items()}
            for layer in mem
        ]
    if isinstance(mem, dict) and "anc" in mem:
        return {**mem, "cache": _materialize_mem(mem["cache"], n_bh)}
    return _map_leaves(mem, lambda t: _materialize(t, n_bh))


class S2SBaseSearcher:
    """Base class: subclasses implement the three functions below.

    Arguments
    ---------
    bos_index / eos_index : int
    min_decode_ratio / max_decode_ratio : float
        Decode-step bounds as a ratio of encoder length.
    """

    def __init__(self, bos_index, eos_index, min_decode_ratio,
                 max_decode_ratio):
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.min_decode_ratio = min_decode_ratio
        self.max_decode_ratio = max_decode_ratio

    def reset_mem(self, batch_size, enc_states, enc_lens):
        """Return the initial memory (leading dim batch_size)."""
        raise NotImplementedError

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        """One decode step: returns (log_probs (N, V), new_memory, attn)."""
        raise NotImplementedError

    def permute_mem(self, memory, index):
        """Reorder memory rows by ``index`` (predecessor gather)."""
        return gather_tree(memory, index)

    def change_max_decoding_length(self, min_decode_steps, max_decode_steps):
        return min_decode_steps, max_decode_steps


def _check_device(device, enc_states):
    if enc_states.device.type != device.type:
        raise ValueError(
            f"this searcher runs on {device}, but the encoder states lie "
            f"on {enc_states.device}"
        )


class S2SGreedySearcher(S2SBaseSearcher):
    """Greedy decoding with finished masking: a finished row only appends
    eos and adds nothing to its score. The loop stops once every row has
    finished (one host synchronisation a step), which is the same as running
    out the bound: the buffers after it hold what the masked steps would
    have written (eos, zero log-probabilities).

    Returns (hyps, lengths, scores, log_probs): hyps a list of Python lists
    cut at the first eos, numpy lengths and scores, and the step log-probs
    (B, max_steps, V) as numpy.
    """

    def __init__(self, bos_index, eos_index, min_decode_ratio=0.0,
                 max_decode_ratio=1.0, device="cuda"):
        super().__init__(
            bos_index, eos_index, min_decode_ratio, max_decode_ratio
        )
        self.device = torch.device(device)
        # number of decode steps the last call ran (before the early exit)
        self.last_steps = 0

    @torch.no_grad()
    def __call__(self, enc_states, wav_len):
        _check_device(self.device, enc_states)
        B, T = enc_states.shape[0], enc_states.shape[1]
        max_steps = max(1, int(T * self.max_decode_ratio))
        _, max_steps = self.change_max_decoding_length(0, max_steps)
        dev = enc_states.device
        memory = self.reset_mem(B, enc_states, wav_len)
        tokens = torch.full(
            (B,), self.bos_index, dtype=torch.int32, device=dev
        )
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        scores = torch.zeros((B,), device=dev)
        tokens_seq = torch.full(
            (max_steps, B), self.eos_index, dtype=torch.int32, device=dev
        )
        lp_seq = None
        step = 0
        while step < max_steps and not bool(finished.all()):
            log_probs, memory, _ = self.forward_step(
                tokens, memory, enc_states, wav_len, step
            )
            log_probs = log_probs.float()
            if lp_seq is None:
                lp_seq = log_probs.new_zeros(
                    (max_steps, B, log_probs.shape[-1])
                )
            step_scores, next_tokens = log_probs.max(dim=-1)
            next_tokens = torch.where(
                finished, self.eos_index, next_tokens.to(torch.int32)
            )
            scores = scores + torch.where(finished, 0.0, step_scores)
            finished = finished | (next_tokens == self.eos_index)
            tokens_seq[step] = next_tokens
            lp_seq[step] = log_probs
            tokens = next_tokens
            step += 1
        self.last_steps = step
        hyps, lengths = _trim_eos_batch(
            tokens_seq.t().cpu().numpy(), self.eos_index
        )
        return (
            hyps, lengths, scores.cpu().numpy(),
            lp_seq.transpose(0, 1).cpu().numpy(),
        )


def _trim_eos_batch(tokens, eos_index):
    """Cut each row of a (B, L) numpy array at its first eos."""
    hyps, lengths = [], []
    for row in tokens:
        row = row.tolist()
        if eos_index in row:
            row = row[: row.index(eos_index)]
        hyps.append(row)
        lengths.append(len(row))
    return hyps, np.asarray(lengths)


class S2SBeamSearcher(S2SBaseSearcher):
    """Batched beam search with upstream SpeechBrain's selection
    semantics:

    * top-``beam_size`` selection over the ``beam_size * vocab``
      candidate scores each step — an eos candidate keeps its beam slot
      for that step, is recorded into the finished set (append order =
      beam-slot order, capped at ``beam_size`` per utterance), and its
      sequence score is masked to ``minus_inf`` so the slot dies out;
    * the decoder log-probs are scaled by ``attn_weight = 1 -
      ctc_weight`` when a CTC scorer is fused; with ``ctc_weight == 1.0``
      the decoder step is skipped entirely and the search is driven by
      the scorers alone;
    * eos is blocked below ``min_decode_steps`` and by the eos threshold
      BEFORE the scorers run;
    * length normalization divides candidate scores by ``step + 1``
      before selection; recorded finished scores are the normalized ones;
    * after the loop, utterances with fewer than ``beam_size`` finished
      hypotheses are topped up from the alive beams in slot order, with
      length ``max_steps`` so that the final trim drops their last token.

    The loop stops once every utterance has recorded ``beam_size``
    finished hypotheses; reading that count is one host synchronisation
    per step. ``temperature`` must be applied to LOGITS inside
    ``forward_step`` / the decode callable; the loop applies none.

    ``device`` is the device the search runs on; encoder states that lie
    elsewhere are refused.
    """

    def __init__(
        self,
        bos_index,
        eos_index,
        min_decode_ratio,
        max_decode_ratio,
        beam_size,
        scorer=None,
        length_normalization=True,
        length_rewarding=0.0,
        using_eos_threshold=True,
        eos_threshold=1.5,
        using_max_attn_shift=False,
        max_attn_shift=60,
        topk=1,
        temperature=1.0,
        return_topk=False,
        minus_inf=-1e20,
        device="cuda",
    ):
        super().__init__(
            bos_index, eos_index, min_decode_ratio, max_decode_ratio
        )
        self.beam_size = beam_size
        self.scorer = scorer
        self.length_normalization = length_normalization
        self.length_rewarding = length_rewarding
        if length_normalization and length_rewarding > 0:
            raise ValueError(
                "length normalization and length rewarding are exclusive"
            )
        self.using_eos_threshold = using_eos_threshold
        self.eos_threshold = eos_threshold
        self.topk = topk
        self.temperature = temperature
        self.return_topk = return_topk
        self.minus_inf = minus_inf
        self.using_max_attn_shift = using_max_attn_shift
        self.max_attn_shift = max_attn_shift
        self.device = torch.device(device)
        self.reset_mem_uninflated = False
        # number of decode steps the last call ran (before the early exit)
        self.last_steps = 0
        # joint CTC/attention weighting
        self.attn_weight = 1.0
        self.ctc_weight = 0.0
        if scorer is not None and scorer.weights.get("ctc", 0.0) > 0.0:
            self.ctc_weight = scorer.weights["ctc"]
            self.attn_weight = 1.0 - self.ctc_weight

    # -- main entry ---------------------------------------------------------
    @torch.no_grad()
    def __call__(self, enc_states, wav_len):
        _check_device(self.device, enc_states)
        B, T = enc_states.shape[0], enc_states.shape[1]
        min_steps = int(T * self.min_decode_ratio)
        max_steps = max(1, int(T * self.max_decode_ratio))
        min_steps, max_steps = self.change_max_decoding_length(
            min_steps, max_steps
        )
        if self.scorer is not None:
            self.scorer.set_beam_layout(B, self.beam_size)
        fin_seq, fin_scores, fin_lens, fin_count = self._search(
            enc_states, wav_len, min_steps, max_steps
        )
        return self._gather_results(
            fin_seq.cpu().numpy(),
            fin_scores.cpu().numpy(),
            fin_lens.cpu().numpy(),
            fin_count.cpu().numpy(),
        )

    def _record_finished(
        self, record, norm_scores, seq, seq_len,
        fin_seq, fin_scores, fin_lens, fin_count,
    ):
        """Append the ``record``-flagged beam rows to the finished set in
        beam-slot order, capped at beam_size per utterance. Rows that are
        not written go to a drop slot ``K`` that is sliced off."""
        B, K = record.shape
        rec = record.to(torch.int32)
        rank = torch.cumsum(rec, dim=1, dtype=torch.int32) - rec
        pos = fin_count[:, None] + rank
        write = record & (pos < K)
        pos_c = torch.where(write, pos, K).long()
        pad_sc = torch.cat(
            [fin_scores, fin_scores.new_full((B, 1), self.minus_inf)], dim=1
        )
        fin_scores = pad_sc.scatter(1, pos_c, norm_scores)[:, :K]
        L = fin_seq.shape[-1]
        pad_seq = torch.cat([fin_seq, fin_seq.new_zeros((B, 1, L))], dim=1)
        fin_seq = pad_seq.scatter(
            1, pos_c[:, :, None].expand(B, K, L), seq
        )[:, :K]
        pad_ln = torch.cat([fin_lens, fin_lens.new_zeros((B, 1))], dim=1)
        fin_lens = pad_ln.scatter(1, pos_c, seq_len)[:, :K]
        fin_count = fin_count + write.sum(dim=1, dtype=torch.int32)
        return fin_seq, fin_scores, fin_lens, fin_count

    def _search(self, enc_states, wav_len, min_steps, max_steps):
        B = enc_states.shape[0]
        K = self.beam_size
        n_bh = B * K
        dev = enc_states.device

        # beam-inflate encoder states: (B*K, T, D)
        enc_inflated = inflate_tensor(enc_states, K, dim=0)
        lens_inflated = inflate_tensor(wav_len, K, dim=0)
        if self.reset_mem_uninflated:
            # beam-shared caches (e.g. precomputed cross-attention K/V)
            # are built from the per-utterance states; per-hypothesis
            # buffers are still allocated at n_bh by the init fn
            memory = self.reset_mem(n_bh, enc_states, wav_len)
        else:
            memory = self.reset_mem(n_bh, enc_inflated, lens_inflated)
        memory = _materialize_mem(memory, n_bh)
        scorer_mem = None
        if self.scorer is not None:
            if self.reset_mem_uninflated:
                scorer_mem = self.scorer.reset_scorer_mem(
                    enc_inflated, lens_inflated,
                    x_shared=enc_states, lens_shared=wav_len,
                )
            else:
                scorer_mem = self.scorer.reset_scorer_mem(
                    enc_inflated, lens_inflated
                )

        # only beam 0 of each batch is live at step 0 (avoid duplicates)
        seq_scores = torch.tensor(
            [0.0] + [self.minus_inf] * (K - 1), device=dev
        ).repeat(B)  # (n_bh,)
        seq = torch.zeros((n_bh, max_steps), dtype=torch.int32, device=dev)
        fin_seq = torch.zeros(
            (B, K, max_steps), dtype=torch.int32, device=dev
        )
        fin_scores = torch.full((B, K), self.minus_inf, device=dev)
        fin_lens = torch.zeros((B, K), dtype=torch.int32, device=dev)
        fin_count = torch.zeros((B,), dtype=torch.int32, device=dev)
        last_norm_scores = torch.full((B, K), self.minus_inf, device=dev)
        prev_tokens = torch.full(
            (n_bh,), self.bos_index, dtype=torch.int32, device=dev
        )
        prev_attn_peak = torch.zeros((n_bh,), dtype=torch.int32, device=dev)
        batch_offset = (torch.arange(B, device=dev) * K)[:, None]

        step = 0
        # The early exit: once every utterance has recorded beam_size
        # finished hypotheses, further steps cannot write anything (the
        # finished set is append-capped at K), and the fill after the loop
        # writes nothing either. Reading fin_count synchronises with the
        # device once per step.
        while step < max_steps and bool((fin_count < K).any()):
            attn = None
            if self.attn_weight > 0:
                log_probs, memory, attn = self.forward_step(
                    prev_tokens, memory, enc_inflated, lens_inflated, step
                )
                log_probs = self.attn_weight * log_probs
            else:
                # pure-CTC decoding: the decoder step is skipped and the
                # scorers drive the search
                log_probs = torch.zeros(
                    (n_bh, self._n_out()), dtype=torch.float32, device=dev
                )
            V = log_probs.shape[-1]
            cur_attn_peak = prev_attn_peak
            if self.using_max_attn_shift:
                # Block hypotheses whose attention peak jumps more than
                # max_attn_shift frames: all their extensions get -inf, so
                # they fall out of the beam.
                cur_attn_peak = torch.argmax(
                    attn.reshape(n_bh, -1), dim=-1
                ).to(torch.int32)
                within = (
                    torch.abs(cur_attn_peak - prev_attn_peak)
                    <= self.max_attn_shift
                )
                if step == 0:
                    # step 0 has no previous peak; never block it
                    within = torch.ones_like(within)
                log_probs = torch.where(
                    within[:, None], log_probs, self.minus_inf
                )
            # eos masking BEFORE the scorers: min-steps block, then eos
            # threshold, then scorer fusion
            eos_score = log_probs[:, self.eos_index].clone()
            if step < min_steps:
                eos_score.fill_(self.minus_inf)
            if self.using_eos_threshold:
                log_probs[:, self.eos_index] = eos_score
                max_logp = log_probs.max(dim=-1).values
                eos_blocked = eos_score <= (self.eos_threshold * max_logp)
                eos_score = torch.where(
                    eos_blocked, self.minus_inf, eos_score
                )
            log_probs[:, self.eos_index] = eos_score
            if self.scorer is not None:
                log_probs, scorer_mem = self.scorer.score(
                    prev_tokens, scorer_mem, attn, log_probs, self.beam_size
                )
            if self.length_rewarding:
                log_probs = log_probs + self.length_rewarding

            # candidate scores + top-K selection over beam*vocab
            cand = (seq_scores[:, None] + log_probs).reshape(B, K * V)
            if self.length_normalization:
                cand = cand / (step + 1)
            top_norm, top_idx = top_k_lowest_index(cand, K)  # (B, K)
            src_beam = top_idx // V
            token_idx = top_idx % V  # (B, K)
            new_tokens = token_idx.reshape(n_bh).to(torch.int32)
            if self.length_normalization:
                new_seq_scores = (top_norm * (step + 1)).reshape(n_bh)
            else:
                new_seq_scores = top_norm.reshape(n_bh)

            predecessors = (src_beam + batch_offset).reshape(-1)
            seq = seq.index_select(0, predecessors)
            seq[:, step] = new_tokens

            memory = self._permute_attn_mem(memory, predecessors)
            prev_attn_peak = cur_attn_peak.index_select(0, predecessors)
            if self.scorer is not None:
                scorer_mem = self.scorer.permute_scorer_mem(
                    scorer_mem, predecessors, new_tokens
                )

            # record eos selections into the finished set (slot order)
            is_eos = token_idx == self.eos_index  # (B, K)
            fin_seq, fin_scores, fin_lens, fin_count = self._record_finished(
                is_eos, top_norm, seq.reshape(B, K, max_steps),
                torch.full((B, K), step + 1, dtype=torch.int32, device=dev),
                fin_seq, fin_scores, fin_lens, fin_count,
            )
            # eos'd slots die out
            seq_scores = torch.where(
                is_eos.reshape(n_bh), self.minus_inf, new_seq_scores
            )
            prev_tokens = new_tokens
            last_norm_scores = top_norm
            step += 1
        self.last_steps = step

        # top up under-full beams from the alive rows in slot order; the
        # filled rows carry length max_steps so the final trim drops their
        # last token
        fill = torch.ones((B, K), dtype=torch.bool, device=dev)
        return self._record_finished(
            fill, last_norm_scores, seq.reshape(B, K, max_steps),
            torch.full((B, K), max_steps, dtype=torch.int32, device=dev),
            fin_seq, fin_scores, fin_lens, fin_count,
        )

    def _permute_attn_mem(self, memory, predecessors):
        """Predecessor gather of the decoder memory; skipped entirely in
        pure-CTC mode."""
        if self.attn_weight > 0:
            return self.permute_mem(memory, predecessors)
        return memory

    def _n_out(self):
        """Vocab size for the pure-CTC (attn_weight == 0) path, where no
        decoder forward provides it. Taken from the CTC scorer."""
        scorers = {**self.scorer.full_scorers, **self.scorer.partial_scorers}
        return scorers["ctc"].vocab_size

    def _gather_results(self, fin_seq, fin_scores, fin_lens, fin_count):
        """Host-side final ranking over the recorded finished set (numpy
        arrays). Each stored length includes the terminating eos (or the
        drop-last-token fill), so the emitted hypothesis is ``len - 1``
        tokens."""
        B, K, L = fin_seq.shape
        hyps, scores, lengths = [], [], []
        topk_hyps, topk_scores, topk_lengths = [], [], []
        for b in range(B):
            order = np.argsort(-fin_scores[b], kind="stable")
            rows = [
                (
                    float(fin_scores[b, k]),
                    fin_seq[b, k, : max(0, int(fin_lens[b, k]) - 1)].tolist(),
                    max(0, int(fin_lens[b, k]) - 1),
                )
                for k in order
            ]
            hyps.append(rows[0][1])
            scores.append(rows[0][0])
            lengths.append(rows[0][2])
            topk_hyps.append([r[1] for r in rows[: self.topk]])
            topk_scores.append([r[0] for r in rows[: self.topk]])
            topk_lengths.append([r[2] for r in rows[: self.topk]])
        if self.return_topk:
            return hyps, np.asarray(lengths), np.asarray(scores), (
                topk_hyps, topk_scores, topk_lengths,
            )
        return hyps, np.asarray(lengths), np.asarray(scores), None


# ---------------------------------------------------------------------------
# Searchers that re-decode the whole token buffer every step
# ---------------------------------------------------------------------------

class _TokenBufferMixin:
    """The memory is a (N, max_length) token buffer, eos-filled, that starts
    with bos; each step writes the consumed token at position ``step`` and
    runs ``decode_fn(buffer, enc_states, enc_lens)`` -> (log-probs of every
    position (N, max_length, V), attention) over the whole buffer, reading
    position ``step``. Simple and O(L^2) a search: a cheap decode for a
    valid stage."""

    def reset_mem(self, batch_size, enc_states, enc_lens):
        buf = torch.full(
            (batch_size, self.max_length), self.eos_index,
            dtype=torch.int32, device=enc_states.device,
        )
        buf[:, 0] = self.bos_index
        return {"tokens": buf}

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        buf = memory["tokens"].clone()
        buf[:, step] = inp_tokens
        log_probs_all, attn = self.decode_fn(buf, enc_states, enc_lens)
        return log_probs_all[:, step], {"tokens": buf}, attn


class S2STransformerGreedySearcher(_TokenBufferMixin, S2SGreedySearcher):
    """Greedy search over a TransformerASR decode half (see
    ``_TokenBufferMixin``)."""

    def __init__(self, decode_fn, vocab_size, max_length=512, **kwargs):
        super().__init__(**kwargs)
        self.decode_fn = decode_fn
        self.vocab_size = vocab_size
        self.max_length = max_length


class S2STransformerBeamSearcher(_TokenBufferMixin, S2SBeamSearcher):
    """Beam search over TransformerASR.decode (see ``_TokenBufferMixin``);
    the token buffer is permuted with the beams."""

    def __init__(self, decode_fn, max_length=512, **kwargs):
        super().__init__(**kwargs)
        self.decode_fn = decode_fn
        self.max_length = max_length


# ---------------------------------------------------------------------------
# KV-cached searchers: O(L) per decode step via explicit per-layer K/V
# buffers instead of re-running the decoder over the whole token buffer
# (the serving-speed path; pairs with TransformerASR.decode_step)
# ---------------------------------------------------------------------------

class _KVDecodeMixin:
    """``decode_step_fn(tokens (N,), cache, enc_states, enc_lens, step)``
    -> (vocab log-probs (N, V), cache, attn);
    ``init_cache_fn(n, enc_states, enc_lens)`` -> per-layer cache whose
    "self" tensors are batch-leading (the beam predecessor gather
    permutes axis 0).

    ``ancestry_kv=True`` switches to ancestry beam decoding
    (ops/beam_attention.py): self-KV cache rows never move — the per-step
    permute of the caches is replaced by a small int32 ancestry-table
    gather, and ``decode_step_fn`` must accept a sixth ``anc`` argument
    (B_utt, beam, L) that it forwards into the model's cached
    attention."""

    def _setup_kv(self, decode_step_fn, init_cache_fn,
                  shared_cross_kv=False, ancestry_kv=False):
        self.decode_step_fn = decode_step_fn
        self.init_cache_fn = init_cache_fn
        # build the cache from UNINFLATED encoder states: cross K/V stay
        # per-utterance and broadcast over beams inside the attention
        self.reset_mem_uninflated = shared_cross_kv
        self.ancestry_kv = ancestry_kv

    def reset_mem(self, batch_size, enc_states, enc_lens):
        cache = self.init_cache_fn(batch_size, enc_states, enc_lens)
        if not self.ancestry_kv:
            return cache
        K = self.beam_size
        anc = init_ancestry(
            batch_size // K, K, cache_length(cache), enc_states.device
        )
        return {"cache": cache, "anc": anc}

    def permute_mem(self, memory, index):
        """Predecessor gather of the per-hypothesis cache — EXCEPT the
        per-layer "cross" entries (precomputed cross-attention K/V of the
        static encoder memory): those are identical across the beams of
        one utterance, and predecessors only permute within an
        utterance. The per-layer K/V buffers go through the row-gather
        kernel (``ops/gather.py``), one launch a buffer."""
        if self.ancestry_kv:
            # cache rows NEVER move; only the ancestry table is gathered
            return {
                "cache": memory["cache"],
                "anc": permute_ancestry(memory["anc"], index),
            }
        return [
            {
                k: (v if k == "cross" else gather_pytree(v, index))
                for k, v in layer.items()
            }
            for layer in memory
        ]

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        if self.ancestry_kv:
            # position ``step`` is written by each row itself THIS step,
            # so its ancestry entry must read "own row" now; the value
            # left there by earlier permutes is stale. Stamping it here
            # (before the end-of-step permute) also makes the permute
            # record the correct writer for all future steps.
            anc = _stamp_self_column(memory["anc"], step)
            log_probs, new_cache, attn = self.decode_step_fn(
                inp_tokens, memory["cache"], enc_states, enc_lens, step,
                anc,
            )
            return log_probs, {"cache": new_cache, "anc": anc}, attn
        return self.decode_step_fn(
            inp_tokens, memory, enc_states, enc_lens, step
        )


class S2SKVGreedySearcher(_KVDecodeMixin, S2SGreedySearcher):
    """Greedy decoding over a KV-cached decode step."""

    def __init__(self, decode_step_fn, init_cache_fn, **kwargs):
        S2SGreedySearcher.__init__(self, **kwargs)
        self._setup_kv(decode_step_fn, init_cache_fn)


class S2SKVBeamSearcher(_KVDecodeMixin, S2SBeamSearcher):
    """Batched beam search over a KV-cached decode step: hypothesis K/V
    buffers ride the standard predecessor gather (axis-0 permute of the
    cache), or — with ``ancestry_kv=True`` — never move at all (ancestry
    beam decoding, the serving path)."""

    def __init__(self, decode_step_fn, init_cache_fn,
                 shared_cross_kv=False, ancestry_kv=False, **kwargs):
        S2SBeamSearcher.__init__(self, **kwargs)
        self._setup_kv(decode_step_fn, init_cache_fn,
                       shared_cross_kv=shared_cross_kv,
                       ancestry_kv=ancestry_kv)


# ---------------------------------------------------------------------------
# Searchers over an attentional RNN decoder
# ---------------------------------------------------------------------------

class _StepFnMixin:
    """``init_fn(n, enc_states, enc_lens)`` builds the decoder state (a
    dict of batch-leading tensors, such as
    ``AttentionalRNNDecoder.init_state`` with a uniform ``prev_attn``);
    ``step_fn(inp_tokens, state, enc_states, enc_lens)`` returns
    ``(log_probs (N, V), new_state, attn (N, T))``. The state is permuted
    with the beams by ``index_select`` along axis 0."""

    def reset_mem(self, batch_size, enc_states, enc_lens):
        return self.init_fn(batch_size, enc_states, enc_lens)

    def forward_step(self, inp_tokens, memory, enc_states, enc_lens, step):
        return self.step_fn(inp_tokens, memory, enc_states, enc_lens)


class S2SRNNGreedySearcher(_StepFnMixin, S2SGreedySearcher):
    """Greedy search for ``AttentionalRNNDecoder`` models (see
    ``_StepFnMixin``)."""

    def __init__(self, step_fn, init_fn, **kwargs):
        super().__init__(**kwargs)
        self.step_fn = step_fn
        self.init_fn = init_fn


class S2SRNNBeamSearcher(_StepFnMixin, S2SBeamSearcher):
    """Beam search for ``AttentionalRNNDecoder`` models (see
    ``_StepFnMixin``)."""

    def __init__(self, step_fn, init_fn, **kwargs):
        super().__init__(**kwargs)
        self.step_fn = step_fn
        self.init_fn = init_fn
