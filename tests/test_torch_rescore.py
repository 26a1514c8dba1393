"""N-best rescoring and the search memory helpers against the JAX package,
at a small size:

* ``RNNLMRescorer`` and ``TransformerLMRescorer`` over the JAX LMs' weights
  (random, drawn with numpy and bridged), on hypotheses of unequal length,
  the empty one included: sums of teacher-forced log-probabilities with
  eos, within 1e-5;
* ``RescorerBuilder``: rows with fewer hypotheses than the widest, ties in
  the combined scores (the rerank is numpy's ``argsort`` as JAX's), the
  reranked lists and scores against JAX's;
* the buffer ``TransformerLMScorer`` stepped with beam permutes, against
  JAX's and against the port's ``KVTransformerLMScorer`` (1e-5);
* ``_materialize_mem`` (a leading-dim-1 leaf, a ``"cross"`` entry, an
  ``"anc"`` table), and a beam search whose initial memory is one shared
  row, against JAX's; ``update_mem`` and ``mask_by_condition``.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.decoders import scorer as jscorer
from speechbrain_tpu.decoders import seq2seq as jseq
from speechbrain_tpu.decoders import utils as jutils
from speechbrain_tpu.lobes.models.RNNLM import RNNLM as JaxRNNLM
from speechbrain_tpu.lobes.models.transformer.TransformerLM import (
    TransformerLM as JaxTLM,
)
from speechbrain_tpu_torch.decoders import scorer as tscorer
from speechbrain_tpu_torch.decoders import seq2seq as tseq
from speechbrain_tpu_torch.decoders import utils as tutils
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _jax, _t, draw_variables

ATOL = 1e-5
V, BOS, EOS = 13, 1, 2
TLM_KW = dict(vocab=V, d_model=16, nhead=2, num_encoder_layers=2, d_ffn=32)
RNN_KW = dict(output_neurons=V, embedding_dim=8, rnn_neurons=12,
              dnn_neurons=10, dropout=0.0)
# hypotheses of unequal length, one empty, padded with a junk id
HYPS = [[3, 4, 5, 6], [7], [], [8, 9, 10, 11, 12], [4, 4]]


def _padded(hyps):
    L = max(len(h) for h in hyps)
    tokens = np.full((len(hyps), L), 6, np.int32)
    for i, h in enumerate(hyps):
        tokens[i, :len(h)] = h
    return tokens, np.array([len(h) for h in hyps], np.int32)


@pytest.fixture(scope="module")
def lms():
    ids = jnp.zeros((2, 5), jnp.int32)
    jtlm = JaxTLM(**TLM_KW)
    tv = draw_variables(jtlm, ids, seed=3)
    jrnn = JaxRNNLM(**RNN_KW)
    rv = draw_variables(jrnn, ids, seed=4)
    tlm = load(TransformerLM(**TLM_KW, device="cpu").eval(), tv)
    rnn = load(RNNLM(**RNN_KW, device="cpu").eval(), rv)
    return {"jtlm": (jtlm, _jax(tv)), "jrnn": (jrnn, _jax(rv)),
            "tlm": tlm, "rnn": rnn}


def _rescorers(lms, temperature=1.0):
    jtlm, tv = lms["jtlm"]
    jrnn, rv = lms["jrnn"]
    kw = dict(bos_index=BOS, eos_index=EOS, temperature=temperature)
    # each LM compiled as one program (faster than op by op)
    rnn_fn = jax.jit(lambda t: jrnn.apply(rv, t))
    jax_side = {
        "rnn": jscorer.RNNLMRescorer(
            lambda t, s: rnn_fn(t), lambda n: None, **kw),
        "transformer": jscorer.TransformerLMRescorer(
            jax.jit(lambda t: jtlm.apply(tv, t)), **kw),
    }
    port = {
        "rnn": tscorer.RNNLMRescorer(
            lambda t, s: lms["rnn"](t, hx=s), lambda n: None, device="cpu",
            **kw),
        "transformer": tscorer.TransformerLMRescorer(
            lms["tlm"], device="cpu", **kw),
    }
    return jax_side, port


@pytest.mark.parametrize("kind", ["rnn", "transformer"])
@pytest.mark.parametrize("temperature", [1.0, 1.3])
def test_rescorers_match_jax(lms, kind, temperature):
    jax_side, port = _rescorers(lms, temperature)
    tokens, lens = _padded(HYPS)
    ours = port[kind].rescore(tokens, lens)
    assert ours.dtype == torch.float32 and ours.shape == (len(HYPS),)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jax_side[kind].rescore(tokens, lens)),
                               atol=ATOL)
    # tensors in, the same scores; the padding past each length is unread
    junk = tokens.copy()
    for i, n in enumerate(lens):
        junk[i, n:] = 12
    np.testing.assert_allclose(
        port[kind].rescore(torch.from_numpy(junk), torch.from_numpy(lens)),
        ours.numpy(), atol=ATOL)


def test_pad_topk_matches_jax():
    rows = [[[3, 4], [5]], [[6, 7, 8]], [[], [9]]]
    for a, b in zip(tscorer.BaseRescorerInterface.pad_topk(rows),
                    jscorer.BaseRescorerInterface.pad_topk(rows)):
        np.testing.assert_array_equal(a, b)


def _same_rerank(ours, theirs):
    assert ours[0] == [list(h) for h in theirs[0]]
    np.testing.assert_allclose(ours[1], theirs[1], atol=ATOL)
    assert ours[2][0] == [[list(h) for h in row] for row in theirs[2][0]]
    for a, b in zip(ours[2][1], theirs[2][1]):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_rescorer_builder_matches_jax(lms):
    """Both rescorers at their own weights (and one unnamed, weight 1.0);
    the second utterance has two hypotheses of three, its third score a
    filler the list drops."""
    jax_side, port = _rescorers(lms)
    topk = [[[3, 4, 5], [7], [8, 9]], [[4, 4], [10, 11, 12, 3]]]
    scores = [[-1.5, -2.25, -2.75], [-0.5, -3.0, -1e9]]
    weights = {"rnn": 0.5, "transformer": 0.25}
    ours = tscorer.RescorerBuilder(weights, port).rescore(topk, scores)
    theirs = jscorer.RescorerBuilder(weights, jax_side).rescore(topk, scores)
    _same_rerank(ours, theirs)
    assert len(ours[2][0][1]) == 2
    ours = tscorer.RescorerBuilder({}, port).rescore(topk, scores)
    theirs = jscorer.RescorerBuilder({}, jax_side).rescore(topk, scores)
    _same_rerank(ours, theirs)


class Flat:
    """A rescorer that gives every hypothesis the same score."""

    def rescore(self, tokens, lens):
        return np.zeros(np.asarray(lens).shape, np.float32)


class FlatTorch(Flat):
    def rescore(self, tokens, lens):
        return torch.zeros(np.asarray(lens).shape)


def test_rescorer_builder_ties_follow_numpy_argsort():
    """Equal combined scores: the order is ``np.argsort(-combined)``'s (on
    20 entries numpy's default sort is not the stable order), as JAX's."""
    rng = np.random.default_rng(5)
    K = 20
    topk = [[[int(t) for t in rng.integers(3, V, 1 + k % 4)]
             for k in range(K)]]
    scores = [list(rng.choice([-1.0, -2.0, -3.0], K))]
    ours = tscorer.RescorerBuilder({"lm": 0.3}, {"lm": FlatTorch()}).rescore(
        topk, scores)
    theirs = jscorer.RescorerBuilder({"lm": 0.3}, {"lm": Flat()}).rescore(
        topk, scores)
    _same_rerank(ours, theirs)
    combined = -np.asarray(scores, np.float32)
    order = np.argsort(combined, axis=-1)[0]
    assert ours[2][0][0] == [topk[0][k] for k in order]
    # the data is such that a stable sort would rank the ties otherwise
    assert list(order) != list(np.argsort(combined, kind="stable")[0])


def test_ragged_first_pass_scores_raise_as_in_jax():
    """Score rows of unequal length do not pack into the (B, K) array, in
    either package."""
    topk = [[[3], [4]], [[5]]]
    scores = [[-1.0, -2.0], [-1.0]]
    for module, flat in ((tscorer, FlatTorch()), (jscorer, Flat())):
        with pytest.raises(ValueError):
            module.RescorerBuilder({}, {"lm": flat}).rescore(topk, scores)


# -- the buffer TransformerLM scorer ------------------------------------------

def test_buffer_scorer_matches_jax_and_the_kv_scorer(lms):
    """Six hypotheses (2 utterances x beam 3) stepped 5 times, the beams
    permuted after each step: the buffer scorer's log-probabilities
    against JAX's buffer scorer and the port's KV-cached scorer."""
    jtlm, tv = lms["jtlm"]
    tlm = lms["tlm"]
    n, steps, L, T = 6, 5, 8, 1.2
    rng = np.random.default_rng(6)
    x = torch.zeros(n, 3, 4)
    j_sc = jscorer.TransformerLMScorer(jax.jit(lambda b: jtlm.apply(tv, b)),
                                       BOS,
                                       max_length=L, temperature=T,
                                       eos_index=EOS)
    b_sc = tscorer.TransformerLMScorer(tlm, BOS, max_length=L,
                                       temperature=T, eos_index=EOS)
    kv_sc = tscorer.KVTransformerLMScorer(tlm.score_step, tlm.init_cache,
                                          max_length=L, temperature=T)
    j_mem = j_sc.reset_mem(jnp.asarray(x.numpy()), None)
    b_mem = b_sc.reset_mem(x, None)
    kv_mem = kv_sc.reset_mem(x, None)
    tokens = np.full((n,), BOS, np.int32)
    with torch.no_grad():
        for step in range(steps):
            j_lp, j_mem = j_sc.score(jnp.asarray(tokens), j_mem, None, None)
            b_lp, b_mem = b_sc.score(_t(tokens), b_mem, None, None)
            kv_lp, kv_mem = kv_sc.score(_t(tokens), kv_mem, None, None)
            np.testing.assert_allclose(b_lp.numpy(), np.asarray(j_lp),
                                       atol=ATOL)
            np.testing.assert_allclose(b_lp.numpy(), kv_lp.numpy(),
                                       atol=ATOL)
            # predecessors within each utterance's 3 beams
            index = np.concatenate([u * 3 + rng.integers(0, 3, 3)
                                    for u in range(2)])
            j_mem = j_sc.permute_mem(j_mem, jnp.asarray(index))
            b_mem = b_sc.permute_mem(b_mem, torch.from_numpy(index))
            kv_mem = kv_sc.permute_mem(kv_mem, torch.from_numpy(index))
            tokens = rng.integers(3, V, n).astype(np.int32)
    np.testing.assert_array_equal(b_mem["tokens"].numpy(),
                                  np.asarray(j_mem["tokens"]))


# -- memory helpers ----------------------------------------------------------

def test_update_mem_and_mask_by_condition_match_jax():
    a = np.array([[1, 2], [3, 4]], np.int32)
    tok = np.array([5, 6], np.int32)
    np.testing.assert_array_equal(
        tutils.update_mem(_t(tok), None).numpy(),
        np.asarray(jutils.update_mem(jnp.asarray(tok), None)))
    np.testing.assert_array_equal(
        tutils.update_mem(_t(tok), _t(a)).numpy(),
        np.asarray(jutils.update_mem(jnp.asarray(tok), jnp.asarray(a))))
    x = np.array([[0.5, -1.0], [2.0, 3.0]], np.float32)
    cond = np.array([[True, False], [False, True]])
    np.testing.assert_array_equal(
        tutils.mask_by_condition(_t(x), _t(cond), -7.0).numpy(),
        np.asarray(jutils.mask_by_condition(jnp.asarray(x),
                                            jnp.asarray(cond), -7.0)))


def test_materialize_mem_broadcasts_only_hypothesis_leaves():
    n_bh = 6
    shared = torch.arange(4.0)[None]           # (1, 4): a shared start
    cross = (torch.ones(1, 5, 8), torch.ones(1, 5, 8))
    layers = [{"self": {"k": torch.zeros(n_bh, 3, 8),
                        "v": shared.clone()},
               "cross": cross}]
    out = tseq._materialize_mem(layers, n_bh)
    assert out[0]["self"]["k"] is layers[0]["self"]["k"]
    assert out[0]["self"]["v"].shape == (n_bh, 4)
    assert torch.equal(out[0]["self"]["v"], shared.expand(n_bh, 4))
    # rows are copies: a write to one leaves the others
    out[0]["self"]["v"][0, 0] = 9.0
    assert out[0]["self"]["v"][1, 0] == 0.0
    assert out[0]["cross"] is cross
    anc = torch.zeros(2, 3, 1, dtype=torch.int32)   # (B, K, L) with L 1
    wrapped = tseq._materialize_mem({"cache": layers, "anc": anc}, n_bh)
    assert wrapped["anc"] is anc
    assert wrapped["cache"][0]["self"]["v"].shape == (n_bh, 4)
    plain = tseq._materialize_mem({"h": shared, "step": 3,
                                   "c": torch.tensor(1.0)}, n_bh)
    assert plain["h"].shape == (n_bh, 4) and plain["step"] == 3
    assert plain["c"].ndim == 0
    # one hypothesis in all: nothing to broadcast
    assert tseq._materialize_mem({"h": shared}, 1)["h"] is shared


def _toy_decoder(H=6, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((V, H)).astype(np.float32),
            (rng.standard_normal((H, H)) / np.sqrt(H)).astype(np.float32),
            (rng.standard_normal((H, V))).astype(np.float32),
            rng.standard_normal((1, H)).astype(np.float32))


@pytest.mark.parametrize("beam", [3, 4])
def test_beam_search_from_one_shared_row_matches_jax(beam):
    """A recurrent toy decoder whose initial state is a single (1, H) row
    for every hypothesis: the port's search broadcasts it before the first
    permute, as JAX's does, and finds JAX's hypotheses and scores."""
    emb, W, U, h0 = _toy_decoder()
    B, T = 2, 10
    enc = np.zeros((B, T, 4), np.float32)
    lens = np.array([1.0, 0.8], np.float32)
    common = dict(bos_index=BOS, eos_index=EOS, min_decode_ratio=0.0,
                  max_decode_ratio=1.0, beam_size=beam, topk=2,
                  return_topk=True, using_eos_threshold=False)

    def j_step(tok, state, enc_states, enc_lens):
        h = jnp.tanh(jnp.asarray(emb)[tok] + state["h"] @ jnp.asarray(W))
        return jax.nn.log_softmax(h @ jnp.asarray(U), -1), {"h": h}, None

    def t_step(tok, state, enc_states, enc_lens):
        h = torch.tanh(_t(emb)[tok.long()] + state["h"] @ _t(W))
        return torch.log_softmax(h @ _t(U), -1), {"h": h}, None

    jax_out = jseq.S2SRNNBeamSearcher(
        j_step, lambda n, e, l: {"h": jnp.asarray(h0)}, **common)(
        jnp.asarray(enc), jnp.asarray(lens))
    ours = tseq.S2SRNNBeamSearcher(
        t_step, lambda n, e, l: {"h": _t(h0)}, device="cpu", **common)(
        _t(enc), _t(lens))
    assert ours[0] == [list(h) for h in jax_out[0]]
    np.testing.assert_allclose(ours[2], np.asarray(jax_out[2]), atol=ATOL)
    assert ours[3][0] == [[list(h) for h in row] for row in jax_out[3][0]]
