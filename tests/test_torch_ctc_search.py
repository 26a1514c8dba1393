"""The host CTC beam searchers (``CTCBeamSearcher``,
``CTCPrefixBeamSearcher``) against the JAX package's on the same numpy
log-probabilities: relative lengths, near ties, pruning on both sides, a
shallow LM through ``score_tokens``, and the posteriors given as a tensor
(the port copies them to the host once, as float32).

Both searches run in numpy and Python floats, so texts must be identical
and scores equal to 1e-9 (the same operations in the same order)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

from speechbrain_tpu.decoders import ctc as jctc
from speechbrain_tpu_torch.decoders import ctc as tctc

SCORE_ATOL = 1e-9
V = 7
BLANK = 0


def _log_probs(B=3, T=14, seed=0, ties=True):
    """Log-softmax of scaled normal logits; with ``ties`` some frames hold
    two tokens at exactly equal log-probabilities, and one frame's best
    token sits 1e-7 above its runner-up."""
    rng = np.random.default_rng(seed)
    logits = 2.5 * rng.standard_normal((B, T, V)).astype(np.float32)
    if ties:
        logits[:, ::3, 2] = logits[:, ::3, 5]
        logits[:, 1, 4] = logits[:, 1, 3] + np.float32(1e-7)
    logits = logits - logits.max(-1, keepdims=True)
    lse = np.log(np.exp(logits).sum(-1, keepdims=True))
    return (logits - lse).astype(np.float32)


class TokenLM:
    """A deterministic shallow LM over token tuples."""

    def score_tokens(self, text):
        return -0.37 * len(text) - 0.11 * sum(int(t) % 3 for t in text)


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for row_o, row_t in zip(ours, theirs):
        assert [tuple(int(t) for t in b.text) for b in row_o] == \
            [tuple(int(t) for t in b.text) for b in row_t]
        for bo, bt in zip(row_o, row_t):
            assert bo.last_token == bt.last_token
            for field in ("score", "p_blank", "p_non_blank"):
                np.testing.assert_allclose(getattr(bo, field),
                                           getattr(bt, field),
                                           atol=SCORE_ATOL)


CASES = {
    "beam2": dict(beam_size=2, topk=2),
    "beam4_prune": dict(beam_size=4, topk=3, beam_prune_logp=-3.0,
                        token_prune_min_logp=-2.0),
    "beam100": dict(beam_size=100, topk=5),
    # no token reaches the floor on any frame: the argmax alone
    "argmax_fallback": dict(beam_size=6, topk=2, token_prune_min_logp=0.5),
    "lm": dict(beam_size=5, topk=4, alpha=0.7, beta=0.4),
}


@pytest.mark.parametrize("searcher", ["CTCBeamSearcher",
                                      "CTCPrefixBeamSearcher"])
@pytest.mark.parametrize("case", list(CASES))
def test_searchers_match_jax(searcher, case):
    kw = dict(CASES[case])
    if case == "lm":
        kw["lm"] = TokenLM()
    lp = _log_probs()
    wav_lens = np.array([1.0, 0.75, 0.5], np.float32)
    ours = getattr(tctc, searcher)(blank_index=BLANK, **kw)(lp, wav_lens)
    theirs = getattr(jctc, searcher)(blank_index=BLANK, **kw)(lp, wav_lens)
    _same(ours, theirs)
    # round(len * T) frames were read: 14, 10.5 -> 10 (half to even), 7
    assert all(len(row) <= kw["topk"] for row in ours)


def test_tensor_posteriors_are_copied_once_as_float32():
    """A float32 tensor and a bfloat16 one (widened exactly) give the
    numpy array's search; lengths may be a tensor too."""
    lp = _log_probs(seed=1, ties=False)
    lens = np.array([1.0, 0.6, 0.9], np.float32)
    kw = dict(blank_index=BLANK, beam_size=8, topk=3)
    ref = jctc.CTCBeamSearcher(**kw)(lp, lens)
    _same(tctc.CTCBeamSearcher(**kw)(torch.from_numpy(lp),
                                     torch.from_numpy(lens)), ref)
    bf = torch.from_numpy(lp).bfloat16()
    _same(tctc.CTCBeamSearcher(**kw)(bf, torch.from_numpy(lens)),
          jctc.CTCBeamSearcher(**kw)(bf.float().numpy(), lens))


def test_no_lengths_reads_every_frame():
    lp = _log_probs(B=2, seed=2)
    kw = dict(blank_index=BLANK, beam_size=3, topk=2)
    _same(tctc.CTCBeamSearcher(**kw)(lp), jctc.CTCBeamSearcher(**kw)(lp))


def test_vocab_list_lm_spells_the_text():
    """A kenlm-style LM (``score(sentence)``) is read through
    ``vocab_list``, ``_`` as a space; an LM with neither hook adds 0."""

    class SentenceLM:
        def score(self, sentence):
            return -0.2 * len(sentence) - 0.5 * sentence.count(" ")

    vocab = ["<b>", "a", "b", "_", "c", "d", "e"]
    lp = _log_probs(B=2, seed=3)
    for lm in (SentenceLM(), object()):
        kw = dict(blank_index=BLANK, beam_size=4, topk=2, lm=lm,
                  vocab_list=vocab)
        _same(tctc.CTCBeamSearcher(**kw)(lp),
              jctc.CTCBeamSearcher(**kw)(lp))


def test_kenlm_path_without_kenlm_raises_import_error():
    for module in (tctc, jctc):
        with pytest.raises(ImportError, match="kenlm"):
            module.CTCBeamSearcher(blank_index=0,
                                   kenlm_model_path="missing.arpa")


def test_beam_and_logsumexp_helpers_match_jax():
    beam = tctc.CTCBeam((1, 2), 2, -1.5, -0.25, 0.0)
    jbeam = jctc.CTCBeam((1, 2), 2, -1.5, -0.25, 0.0)
    assert beam.p_total == jbeam.p_total
    xs = (-1.0, -3.5, 0.25)
    assert tctc._logsumexp(*xs) == jctc._logsumexp(*xs)
