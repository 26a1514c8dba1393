"""Pluggable scorers for LM fusion and joint decoding in beam search, and
the second-pass rescorers of n-best lists (port of
``BaseScorerInterface``, ``RNNLMScorer``, ``TransformerLMScorer``,
``KVTransformerLMScorer``, ``CTCScorer``, ``CoverageScorer``,
``LengthScorer``, ``ScorerBuilder``, ``BaseRescorerInterface``,
``RNNLMRescorer``, ``TransformerLMRescorer`` and ``RescorerBuilder`` from
``speechbrain_tpu/decoders/scorer.py``).

Scorers run inside the beam-search loop: state in, state out. Full
scorers contribute over the entire vocab; partial scorers (CTC prefix)
score a pruned candidate set of size ``scorer_beam_scale * beam_size`` and
are scattered back. Rescorers score complete hypotheses after the search,
one batched LM forward for the whole n-best list.
"""

import numpy as np
import torch

from speechbrain_tpu_torch.decoders.ctc import CTCPrefixScore
from speechbrain_tpu_torch.decoders.permute import gather_tree
from speechbrain_tpu_torch.decoders.seq2seq import (
    _stamp_self_column,
    cache_length,
    init_ancestry,
    permute_ancestry,
)
from speechbrain_tpu_torch.decoders.utils import top_k_lowest_index
from speechbrain_tpu_torch.ops.gather import gather_pytree


class BaseScorerInterface:
    """Protocol of a scorer."""

    # (batch, beam) of the running search; set by ScorerBuilder
    _beam_layout = None

    def score(self, inp_tokens, memory, candidates, attn):
        """Return (scores, new_memory). For full scorers, scores has shape
        (n_bh, vocab); partial scorers return full-vocab scores too, with
        their own minus-inf at tokens outside ``candidates``."""
        raise NotImplementedError

    def permute_mem(self, memory, index):
        return gather_tree(memory, index)

    def reset_mem(self, x, enc_lens):
        return None

    def is_partial(self):
        return False


class RNNLMScorer(BaseScorerInterface):
    """Shallow fusion with an RNN LM.

    ``lm_fn(tokens (N, 1), state)`` -> ``(logits (N, 1, V), new_state)``;
    ``lm_init(n)`` -> the initial state, batch-leading (so that the beam
    permute gathers its axis 0; an LSTM's ``(layers, N, H)`` state is moved
    at the boundary inside ``lm_fn``).
    """

    def __init__(self, lm_fn, lm_init, temperature=1.0):
        self.lm_fn = lm_fn
        self.lm_init = lm_init
        self.temperature = temperature

    def reset_mem(self, x, enc_lens):
        return self.lm_init(x.shape[0])

    def score(self, inp_tokens, memory, candidates, attn):
        logits, new_state = self.lm_fn(inp_tokens[:, None], memory)
        log_probs = torch.log_softmax(
            logits[:, 0].float() / self.temperature, dim=-1
        )
        return log_probs, new_state


class TransformerLMScorer(BaseScorerInterface):
    """Shallow fusion with a causal transformer LM that re-reads the whole
    hypothesis every step.

    The memory is a ``(N, max_length)`` int32 token buffer, eos-filled with
    bos at slot 0, and the step. Each step writes ``inp_tokens`` at
    ``step``, runs ``lm_fn(buffer)`` -> logits ``(N, max_length, V)`` and
    returns the log-probabilities (over ``temperature``) at ``step``. The
    LM being causal, the slots past ``step`` change nothing, so its scores
    are :class:`KVTransformerLMScorer`'s at O(max_length) the work a step.
    ``permute_mem`` gathers the buffer's rows.
    """

    def __init__(self, lm_fn, bos_index, max_length=512, temperature=1.0,
                 eos_index=0):
        self.lm_fn = lm_fn
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.max_length = max_length
        self.temperature = temperature

    def reset_mem(self, x, enc_lens):
        buf = torch.full((x.shape[0], self.max_length), self.eos_index,
                         dtype=torch.int32, device=x.device)
        buf[:, 0] = self.bos_index
        return {"tokens": buf, "step": 0}

    def score(self, inp_tokens, memory, candidates, attn):
        step = memory["step"]
        buf = memory["tokens"].clone()
        buf[:, step] = inp_tokens
        logits = self.lm_fn(buf)[:, step].float()
        log_probs = torch.log_softmax(logits / self.temperature, dim=-1)
        return log_probs, {"tokens": buf, "step": step + 1}

    def permute_mem(self, memory, index):
        return {"tokens": memory["tokens"].index_select(0, index),
                "step": memory["step"]}


class KVTransformerLMScorer(BaseScorerInterface):
    """KV-cached transformer-LM shallow fusion: O(step) work per decode
    step instead of re-running the LM over the whole token buffer.

    Arguments
    ---------
    step_fn : (tokens (N,), cache, step) -> (logits (N, V), cache)
        e.g. ``lm.score_step``.
    init_cache_fn : (n, max_length) -> per-layer cache with batch-leading
        tensors (the beam predecessor gather permutes axis 0).
    ancestry : bool
        Cache rows never move; ``step_fn`` takes a fourth (B_utt, beam, L)
        ancestry argument and routes it into the LM's cached attention
        (ops/beam_attention.py) — removes the per-step cache permute.
    """

    def __init__(self, step_fn, init_cache_fn, max_length=512,
                 temperature=1.0, ancestry=False):
        self.step_fn = step_fn
        self.init_cache_fn = init_cache_fn
        self.max_length = max_length
        self.temperature = temperature
        self.ancestry = ancestry

    def reset_mem(self, x, enc_lens):
        mem = {
            "cache": self.init_cache_fn(x.shape[0], self.max_length),
            "step": 0,
        }
        if self.ancestry:
            B, K = self._beam_layout
            # match the CACHE's (rounded-up) length
            mem["anc"] = init_ancestry(
                B, K, cache_length(mem["cache"]), x.device
            )
        return mem

    def score(self, inp_tokens, memory, candidates, attn):
        step = memory["step"]
        if self.ancestry:
            anc = _stamp_self_column(memory["anc"], step)
            logits, cache = self.step_fn(
                inp_tokens, memory["cache"], step, anc
            )
        else:
            logits, cache = self.step_fn(inp_tokens, memory["cache"], step)
        log_probs = torch.log_softmax(logits / self.temperature, dim=-1)
        return log_probs, {**memory, "cache": cache, "step": step + 1}

    def permute_mem(self, memory, index):
        if self.ancestry:
            return {**memory, "anc": permute_ancestry(memory["anc"], index)}
        # the LM's per-layer K/V buffers: one row-gather launch each
        return {**memory, "cache": gather_pytree(memory["cache"], index)}


class CTCScorer(BaseScorerInterface):
    """Joint CTC prefix scoring (partial scorer). Its prefix scorer is
    built fresh per utterance batch in ``reset_mem`` from the CTC head's
    log-probs."""

    # the prefix scorer's own mask value — NOT the searcher's minus_inf
    CTC_MINUS_INF = -1e20

    def __init__(self, ctc_fn, blank_index, eos_index, ctc_window_size=0):
        # ctc_fn(enc_states) -> (B*, T, V) CTC log-probs (usually a Linear
        # + log_softmax over the encoder states)
        self.ctc_fn = ctc_fn
        self.blank_index = blank_index
        self.eos_index = eos_index
        self.ctc_window_size = ctc_window_size
        self._impl = None

    @property
    def vocab_size(self):
        return self._impl.V

    def reset_mem(self, x, enc_lens, n_bh=None):
        log_probs = self.ctc_fn(x)
        self._impl = CTCPrefixScore(
            log_probs, enc_lens, self.blank_index, self.eos_index,
            self.ctc_window_size,
        )
        # x may be the UNINFLATED per-utterance states with n_bh =
        # batch*beam hypotheses: the prefix scorer shares the posteriors
        # across each utterance's beams
        n = n_bh or x.shape[0]
        state = self._impl.init_state(n)
        state["is_first"] = torch.ones((n,), dtype=torch.bool, device=x.device)
        return state

    def is_partial(self):
        return True

    def score(self, inp_tokens, memory, candidates, attn):
        """Score candidate extensions; returns FULL-vocab scores with
        -1e20 at unscored tokens, so non-candidates are effectively
        blocked from selection."""
        # inp_tokens are the tokens just consumed (last of prefix g)
        n_bh = inp_tokens.shape[0]
        if candidates is None:
            # full-vocab scoring (ctc_weight == 1.0 paths): every token is
            # a candidate
            candidates = torch.arange(
                self._impl.V, device=inp_tokens.device
            )[None].expand(n_bh, -1)
        _, new_states = self._impl.forward_step(
            memory["is_first"], inp_tokens, candidates, memory
        )
        psi = new_states["psi"]  # (n_bh, n_cand)
        # blank is not a valid extension for joint scoring
        if self.eos_index != self.blank_index:
            psi = torch.where(
                candidates == self.blank_index, self.CTC_MINUS_INF, psi
            )
        new_states["psi"] = psi
        psi_full = psi.new_full((n_bh, self._impl.V), self.CTC_MINUS_INF)
        psi_full.scatter_(1, candidates.long(), psi)
        scores = psi_full - memory["psi_prev"][:, None]
        new_states["candidates"] = candidates
        new_states["is_first"] = torch.zeros_like(memory["is_first"])
        return scores, new_states

    def permute_and_select(self, new_states, hyp_index, new_tokens):
        """Select the forward variables of the chosen (hyp, token) pairs,
        by plain indexing."""
        cands = new_states["candidates"][hyp_index]  # (n_bh, n_cand)
        # find the candidate slot matching each new token
        match = cands == new_tokens[:, None]
        cand_idx = torch.argmax(match.to(torch.int8), dim=-1)
        found = match.any(dim=-1)
        # unscored chosen token: falls back to candidate slot 0's forward
        # variables with psi_prev = minus_inf. argmax already yields 0 on
        # no-match, so only psi needs the mask.
        state = self._impl.select_state(new_states, hyp_index, cand_idx)
        state["psi_prev"] = torch.where(
            found, state["psi_prev"], self.CTC_MINUS_INF
        )
        state["is_first"] = torch.zeros_like(found)
        return state


class CoverageScorer(BaseScorerInterface):
    """Penalise looping or over-attended frames through the accumulated
    attention: ``penalty = sum(max(coverage, threshold)) - T * threshold``,
    divided by the decode step count, the same for every token of a
    hypothesis. A 3-D (transformer) attention replaces the running sum by
    the prefix's attention summed over its queries."""

    def __init__(self, vocab_size, threshold=0.5):
        self.vocab_size = vocab_size
        self.threshold = threshold

    def reset_mem(self, x, enc_lens):
        return {"coverage": x.new_zeros((x.shape[0], x.shape[1]),
                                        dtype=torch.float32),
                "step": 0}

    def score(self, inp_tokens, memory, candidates, attn):
        n = inp_tokens.shape[0]
        step = memory["step"] + 1
        if attn is None:
            return (
                memory["coverage"].new_zeros((n, self.vocab_size)),
                {"coverage": memory["coverage"], "step": step},
            )
        if attn.ndim > 2:
            coverage = attn.float().sum(dim=1)
        else:
            coverage = memory["coverage"] + attn.float()
        T = coverage.shape[-1]
        penalty = (torch.clamp(coverage, min=self.threshold).sum(-1)
                   - T * self.threshold)
        scores = (-penalty / step)[:, None].expand(n, self.vocab_size)
        return scores, {"coverage": coverage, "step": step}

    def permute_mem(self, memory, index):
        return {"coverage": memory["coverage"].index_select(0, index),
                "step": memory["step"]}


class LengthScorer(BaseScorerInterface):
    """A constant reward of 1 per step for every token."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def score(self, inp_tokens, memory, candidates, attn):
        return inp_tokens.new_ones((inp_tokens.shape[0], self.vocab_size),
                                   dtype=torch.float32), None

    def permute_mem(self, memory, index):
        return None


class ScorerBuilder:
    """Combine weighted scorers, full and partial.

    Arguments
    ---------
    weights : dict name -> float
    full_scorers / partial_scorers : dict name -> scorer
    scorer_beam_scale : float
        Candidate set size for partial scorers = scale * beam_size.
    """

    def __init__(self, weights=None, full_scorers=None, partial_scorers=None,
                 scorer_beam_scale=2.0):
        self.weights = dict(weights or {})
        self.full_scorers = dict(full_scorers or {})
        self.partial_scorers = dict(partial_scorers or {})
        self.scorer_beam_scale = scorer_beam_scale

    def _all_scorers(self):
        return {**self.full_scorers, **self.partial_scorers}

    def set_beam_layout(self, batch, beam):
        """Record the (batch, beam) layout of the search about to run
        (the searcher calls this before its loop)."""
        for scorer in self._all_scorers().values():
            scorer._beam_layout = (batch, beam)

    def reset_scorer_mem(self, x, enc_lens, x_shared=None,
                         lens_shared=None):
        """x is the beam-inflated encoder states. When ``x_shared`` (the
        per-utterance states) is given, scorers that can share encoder
        products across beams (the CTC prefix scorer) are reset from it
        instead — their per-hypothesis state still sizes to x.shape[0]."""
        mem = {}
        for name, scorer in self._all_scorers().items():
            if x_shared is not None and isinstance(scorer, CTCScorer):
                mem[name] = scorer.reset_mem(
                    x_shared, lens_shared, n_bh=x.shape[0]
                )
            else:
                mem[name] = scorer.reset_mem(x, enc_lens)
        return mem

    def score(self, inp_tokens, memories, attn, log_probs, beam_size):
        """Add weighted scorer contributions to log_probs inside the beam
        loop: full scorers first (with blank blocking when CTC scores the
        full vocab), then candidate pruning from the fused log-probs,
        then the partial scorers. Partial scorers return FULL-vocab
        scores carrying their own minus-inf at unscored tokens, so a
        plain add suffices."""
        new_mem = {}
        for name, scorer in self.full_scorers.items():
            if name == "ctc":
                # block blank when CTC drives full-vocab scoring
                log_probs[:, scorer.blank_index] = CTCScorer.CTC_MINUS_INF
            scores, sm = scorer.score(
                inp_tokens, memories.get(name), None, attn
            )
            log_probs = log_probs + self.weights.get(name, 1.0) * scores
            new_mem[name] = sm
        if self.partial_scorers:
            n_cand = int(beam_size * self.scorer_beam_scale)
            n_cand = max(1, min(n_cand, log_probs.shape[-1]))
            _, candidates = top_k_lowest_index(log_probs, n_cand)
            for name, scorer in self.partial_scorers.items():
                scores, sm = scorer.score(
                    inp_tokens, memories.get(name), candidates, attn
                )
                log_probs = log_probs + self.weights.get(name, 1.0) * scores
                new_mem[name] = sm
        return log_probs, new_mem

    def permute_scorer_mem(self, memories, index, new_tokens):
        """Reorder all scorer memories after beam pruning. ``index`` is
        the flat predecessor row per surviving hypothesis; ``new_tokens``
        the token each chose."""
        out = {}
        for name, scorer in self._all_scorers().items():
            mem = memories.get(name)
            if mem is None:
                out[name] = None
            elif hasattr(scorer, "permute_and_select"):
                # CTC-style scorers select by (hyp, token) pairs
                out[name] = scorer.permute_and_select(mem, index, new_tokens)
            else:
                out[name] = scorer.permute_mem(mem, index)
        return out


# ---------------------------------------------------------------------------
# N-best rescoring (second pass)
# ---------------------------------------------------------------------------

class BaseRescorerInterface:
    """A second-pass scorer of the beam searcher's n-best lists.

    ``rescore(tokens, lens)`` takes complete hypotheses, ``(N, L)`` int
    token ids (a numpy array or a tensor; bos and eos are added inside)
    and their ``(N,)`` lengths, and returns the ``(N,)`` total LM
    log-probabilities as a float32 tensor on ``device``: one batched
    forward, no loop over hypotheses.
    """

    def rescore(self, tokens, lens):
        raise NotImplementedError

    @staticmethod
    def pad_topk(topk_hyps):
        """The searcher's ``return_topk`` lists (list[batch] of list[k] of
        token lists) packed into ``(B, K, L)`` int32 tokens and ``(B, K)``
        lengths, numpy; rows with fewer than K hypotheses are padded with
        empty ones.

        Example
        -------
        >>> tokens, lens = BaseRescorerInterface.pad_topk([[[3, 4], [5]]])
        >>> tokens.tolist(), lens.tolist()
        ([[[3, 4], [5, 0]]], [[2, 1]])
        """
        B = len(topk_hyps)
        K = max(len(row) for row in topk_hyps)
        L = max((len(h) for row in topk_hyps for h in row), default=1) or 1
        tokens = np.zeros((B, K, L), np.int32)
        lens = np.zeros((B, K), np.int32)
        for b, row in enumerate(topk_hyps):
            for k, hyp in enumerate(row):
                tokens[b, k, : len(hyp)] = hyp
                lens[b, k] = len(hyp)
        return tokens, lens


class _TeacherForcedRescorer(BaseRescorerInterface):
    """The sum over a hypothesis of ``log_softmax(logits / temperature)``
    at its next token: the input is bos + tokens, the target tokens + pad
    with eos written at each length, and the mask ``arange(L + 1) <= lens``
    takes the eos slot in."""

    def __init__(self, bos_index, eos_index, pad_index, temperature,
                 device):
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.pad_index = pad_index
        self.temperature = temperature
        self.device = torch.device(device)

    def _logits(self, inp):
        raise NotImplementedError

    @torch.no_grad()
    def rescore(self, tokens, lens):
        tokens = torch.as_tensor(tokens).to(self.device, torch.int32)
        lens = torch.as_tensor(lens).to(self.device, torch.long)
        N, L = tokens.shape
        inp = torch.cat([tokens.new_full((N, 1), self.bos_index), tokens],
                        dim=1)
        tgt = torch.cat([tokens, tokens.new_full((N, 1), self.pad_index)],
                        dim=1).long()
        tgt[torch.arange(N, device=self.device), lens] = self.eos_index
        logp = torch.log_softmax(self._logits(inp).float()
                                 / self.temperature, dim=-1)
        tok_lp = logp.gather(-1, tgt[..., None])[..., 0]
        mask = torch.arange(L + 1, device=self.device)[None, :] <= lens[:, None]
        return (tok_lp * mask).sum(dim=-1)


class RNNLMRescorer(_TeacherForcedRescorer):
    """N-best rescoring with an RNN LM: ``lm_fn(tokens (N, L), state)`` ->
    ``(logits (N, L, V), state)`` over whole sequences (teacher-forced),
    ``lm_init(n)`` -> the initial state (``None`` for a zero one)."""

    def __init__(self, lm_fn, lm_init, bos_index, eos_index, pad_index=0,
                 temperature=1.0, device="cuda"):
        super().__init__(bos_index, eos_index, pad_index, temperature, device)
        self.lm_fn = lm_fn
        self.lm_init = lm_init

    def _logits(self, inp):
        logits, _ = self.lm_fn(inp, self.lm_init(inp.shape[0]))
        return logits


class TransformerLMRescorer(_TeacherForcedRescorer):
    """N-best rescoring with a causal transformer LM: ``lm_fn(tokens (N,
    L))`` -> logits ``(N, L, V)``."""

    def __init__(self, lm_fn, bos_index, eos_index, pad_index=0,
                 temperature=1.0, device="cuda"):
        super().__init__(bos_index, eos_index, pad_index, temperature, device)
        self.lm_fn = lm_fn

    def _logits(self, inp):
        return self.lm_fn(inp)


class RescorerBuilder:
    """First-pass beam scores combined with weighted second-pass rescorers,
    and the n-best lists reranked.

    ``rescore(topk_hyps, topk_scores)`` takes the beam searcher's
    ``return_topk`` lists (list[B] of list[K] token lists, and their
    scores) and returns ``(best hyps list[B], best scores list[B],
    (reranked hyps, reranked scores))``. The combined score of a
    hypothesis is its first-pass score plus ``weight * LM score`` for each
    rescorer (weight 1.0 where ``weights`` names none), in float32 on the
    host. Each row is reranked by ``np.argsort(-combined)``, numpy's
    default (unstable) sort, as the JAX package ranks it: where two
    hypotheses tie, their order is numpy's, not ``torch.argsort``'s. A row
    of fewer than K hypotheses keeps only its own.

    Example
    -------
    >>> class Flat:
    ...     def rescore(self, tokens, lens):
    ...         return -torch.as_tensor(lens, dtype=torch.float32)
    >>> builder = RescorerBuilder({"lm": 1.0}, {"lm": Flat()})
    >>> best, scores, _ = builder.rescore([[[1, 2, 3], [4]]], [[-1.0, -2.5]])
    >>> best, scores
    ([[4]], [-3.5])
    """

    def __init__(self, weights=None, rescorers=None):
        self.weights = dict(weights or {})
        self.rescorers = dict(rescorers or {})

    def rescore(self, topk_hyps, topk_scores):
        tokens, lens = BaseRescorerInterface.pad_topk(topk_hyps)
        B, K, L = tokens.shape
        flat_tokens = tokens.reshape(B * K, L)
        flat_lens = lens.reshape(B * K)
        combined = np.asarray(
            [[float(s) for s in row] for row in topk_scores], np.float32)
        for name, rescorer in self.rescorers.items():
            lm_scores = rescorer.rescore(flat_tokens, flat_lens)
            if isinstance(lm_scores, torch.Tensor):
                lm_scores = lm_scores.detach().float().cpu().numpy()
            lm_scores = np.asarray(lm_scores).reshape(B, K)
            combined = combined + self.weights.get(name, 1.0) * lm_scores
        order = np.argsort(-combined, axis=-1)
        best_hyps, best_scores, rr_hyps, rr_scores = [], [], [], []
        for b in range(B):
            keep = [k for k in order[b] if k < len(topk_hyps[b])]
            row = [topk_hyps[b][k] for k in keep]
            srow = [float(combined[b, k]) for k in keep]
            rr_hyps.append(row)
            rr_scores.append(srow)
            best_hyps.append(row[0])
            best_scores.append(srow[0])
        return best_hyps, best_scores, (rr_hyps, rr_scores)
