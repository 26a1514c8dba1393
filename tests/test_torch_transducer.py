"""The transducer against the JAX package at a small size: the joint
network (sum and concat, 3-D and expanded inputs), the RNN-T loss (values
at full and partial lengths under every reduction, against JAX and a numpy
dynamic program; its gradient with respect to the log-probabilities against
``jax.grad``), greedy search over an LSTM prediction network, streaming
greedy over two chunks, beam search with and without a fused RNNLM, and
the greedy search's state mask with a 2-layer prediction network at batch
2, where the JAX searcher masks the layer axis (ROADMAP.md C33).

Weights are drawn with numpy into the shapes of flax's variables and
carried into the port through ``utils/jax_bridge``; inputs come from numpy.
Tolerances: joint 1e-5 absolute; loss 1e-4 relative; gradient 1e-5
absolute; tokens equal; beam scores 1e-4 absolute (float32 on both sides,
sums in another order)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.decoders.transducer import (
    TransducerBeamSearcher as JaxSearcher,
)
from speechbrain_tpu.decoders.transducer import (
    TransducerGreedySearcherStreamingContext as JaxContext,
)
from speechbrain_tpu.lobes.models.RNNLM import RNNLM as JaxRNNLM
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.RNN import LSTM as JaxLSTM
from speechbrain_tpu.nnet.transducer_joint import TransducerJoint as JaxJoint
from speechbrain_tpu.nnet.transducer_loss import (
    transducer_loss as jax_transducer_loss,
)
from speechbrain_tpu_torch.decoders.transducer import (
    TransducerBeamSearcher,
    TransducerGreedySearcherStreamingContext,
)
from speechbrain_tpu_torch.integrations.numba import (
    transducer_loss as numba_home,
)
from speechbrain_tpu_torch.lobes.models.RNNLM import RNNLM
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.RNN import LSTM
from speechbrain_tpu_torch.nnet.transducer_joint import TransducerJoint
from speechbrain_tpu_torch.nnet.transducer_loss import (
    TransducerLoss,
    transducer_loss,
)
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_from_shapes

JOINT_ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-5
SCORE_ATOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _variables(module, *args, seed=1, **kwargs):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), KEY)
    return draw_from_shapes(shapes, seed=seed)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- the joint -------------------------------------------------------------

@pytest.mark.parametrize("joint", ["sum", "concat"])
@pytest.mark.parametrize("expanded", [False, True])
def test_joint_matches_jax(joint, expanded):
    enc, dec = _np((2, 5, 6), 0), _np((2, 3, 4), 1)
    if expanded:
        enc, dec = enc[:, :, None, :], dec[:, None, :, :]
    ref = JaxJoint(joint_dim=7, joint=joint)
    variables = _variables(ref, jnp.asarray(enc), jnp.asarray(dec))
    want = ref.apply(_jax(variables), jnp.asarray(enc), jnp.asarray(dec))
    ours = load(TransducerJoint(7, enc_dim=6, dec_dim=4, joint=joint,
                                device="cpu"), variables)
    got = ours(torch.from_numpy(enc), torch.from_numpy(dec))
    assert got.shape == (2, 5, 3, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=JOINT_ATOL)


def test_joint_rejects_an_unknown_type():
    with pytest.raises(ValueError):
        TransducerJoint(4, 4, 4, joint="product", device="cpu")


# -- the loss --------------------------------------------------------------

def _dp_rnnt(log_probs, targets, blank):
    """-log p(targets) over every monotonic alignment, by the lattice's
    dynamic program in float64 numpy (independent of the scan)."""
    T, _, _ = log_probs.shape
    U = len(targets)
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for u in range(1, U + 1):
        alpha[0, u] = alpha[0, u - 1] + log_probs[0, u - 1, targets[u - 1]]
    for t in range(1, T):
        alpha[t, 0] = alpha[t - 1, 0] + log_probs[t - 1, 0, blank]
        for u in range(1, U + 1):
            no_emit = alpha[t - 1, u] + log_probs[t - 1, u, blank]
            emit = alpha[t, u - 1] + log_probs[t, u - 1, targets[u - 1]]
            alpha[t, u] = np.logaddexp(no_emit, emit)
    return -(alpha[T - 1, U] + log_probs[T - 1, U, blank])


def _loss_case(partial):
    B, T, U, V = 3, 7, 4, 6
    x = _np((B, T, U + 1, V), 2).astype(np.float64)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    targets = np.random.default_rng(3).integers(1, V, (B, U)).astype(
        np.int32)
    if partial:
        in_lens = np.array([1.0, 5 / 7, 3 / 7], np.float32)
        tgt_lens = np.array([1.0, 0.5, 0.25], np.float32)
    else:
        in_lens = tgt_lens = np.ones(B, np.float32)
    return lp, targets, in_lens, tgt_lens


def _rows_by_dp(lp, targets, in_lens, tgt_lens, blank=0):
    T, U = lp.shape[1], targets.shape[1]
    rows = []
    for b in range(lp.shape[0]):
        t_abs = int(np.round(in_lens[b] * T))
        u_abs = int(np.round(tgt_lens[b] * U))
        rows.append(_dp_rnnt(lp[b, :t_abs].astype(np.float64),
                             targets[b, :u_abs], blank))
    return np.array(rows), np.array([np.round(l * U) for l in tgt_lens])


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "batchmean", "sum", "batch"])
def test_loss_matches_jax_and_the_dp(partial, reduction):
    lp, targets, in_lens, tgt_lens = _loss_case(partial)
    ours = transducer_loss(torch.from_numpy(lp), torch.from_numpy(targets),
                           torch.from_numpy(in_lens),
                           torch.from_numpy(tgt_lens), 0, reduction)
    ref = jax_transducer_loss(jnp.asarray(lp), jnp.asarray(targets),
                              jnp.asarray(in_lens), jnp.asarray(tgt_lens),
                              0, reduction)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=LOSS_RTOL)
    rows, u_abs = _rows_by_dp(lp, targets, in_lens, tgt_lens)
    dp = {"mean": np.mean(rows / np.maximum(u_abs, 1)),
          "batchmean": np.mean(rows), "sum": np.sum(rows)}.get(reduction,
                                                              rows)
    np.testing.assert_allclose(ours.numpy(), dp, rtol=LOSS_RTOL)


@pytest.mark.parametrize("partial", [False, True])
def test_loss_gradient_matches_jax_grad(partial):
    lp, targets, in_lens, tgt_lens = _loss_case(partial)
    x = torch.from_numpy(lp).requires_grad_(True)
    transducer_loss(x, torch.from_numpy(targets), torch.from_numpy(in_lens),
                    torch.from_numpy(tgt_lens), 0).backward()
    want = jax.grad(lambda v: jax_transducer_loss(
        v, jnp.asarray(targets), jnp.asarray(in_lens),
        jnp.asarray(tgt_lens), 0))(jnp.asarray(lp))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                               atol=GRAD_ATOL)


def test_the_module_and_the_numba_home_are_the_function():
    lp, targets, in_lens, tgt_lens = _loss_case(True)
    args = [torch.from_numpy(a) for a in (lp, targets, in_lens, tgt_lens)]
    want = transducer_loss(*args, 0, "batchmean")
    assert torch.equal(TransducerLoss(0, "batchmean")(*args), want)
    assert numba_home.transducer_loss is transducer_loss
    assert numba_home.TransducerLoss is TransducerLoss


# -- the searchers ---------------------------------------------------------

V, E, H, J, J_ENC, B, T = 7, 5, 6, 8, 4, 3, 6


class Nets:
    """A transducer's decoding networks on both sides, the same weights:
    embedding -> LSTM -> ``dec_proj`` (the prediction network), the sum
    joint and the output head; an optional tiny RNNLM. The blank's
    output bias is raised by ``blank_bias`` so that rows emit blanks
    among labels."""

    def __init__(self, layers=1, seed=10, blank_bias=0.5, lm=False):
        tok = jnp.zeros((B, 1), jnp.int32)
        self.j_emb = JaxEmbedding(num_embeddings=V, embedding_dim=E)
        self.j_lstm = JaxLSTM(hidden_size=H, num_layers=layers)
        self.j_proj = JaxLinear(n_neurons=J)
        self.j_joint = JaxJoint(joint_dim=J, joint="sum")
        self.j_out = JaxLinear(n_neurons=V)
        v = {
            "emb": _variables(self.j_emb, tok, seed=seed),
            "lstm": _variables(self.j_lstm, jnp.zeros((B, 1, E)),
                               seed=seed + 1),
            "proj": _variables(self.j_proj, jnp.zeros((B, 1, H)),
                               seed=seed + 2),
            "joint": _variables(self.j_joint, jnp.zeros((B, 1, 1, J_ENC)),
                                jnp.zeros((B, 1, 1, J)), seed=seed + 3),
            "out": _variables(self.j_out, jnp.zeros((B, 1, 1, J)),
                              seed=seed + 4),
        }
        v["out"]["params"]["bias"][0] += blank_bias
        self.v = {k: _jax(t) for k, t in v.items()}
        self.emb = load(Embedding(V, E, device="cpu"), v["emb"])
        self.lstm = load(LSTM(H, E, num_layers=layers, device="cpu"),
                         v["lstm"])
        self.proj = load(Linear(J, H, device="cpu"), v["proj"])
        self.joint = load(TransducerJoint(J, J_ENC, J, device="cpu"),
                          v["joint"])
        self.out = load(Linear(V, J, device="cpu"), v["out"])
        self.j_lm = self.lm = None
        if lm:
            self.j_lm = JaxRNNLM(output_neurons=V, embedding_dim=4,
                                 dropout=0.0, rnn_layers=1, rnn_neurons=8,
                                 dnn_neurons=6)
            lv = _variables(self.j_lm, jnp.zeros((1, 1), jnp.int32),
                            seed=seed + 5)
            self.v["lm"] = _jax(lv)
            self.lm = load(RNNLM(V, 4, dropout=0.0, rnn_layers=1,
                                 rnn_neurons=8, dnn_neurons=6,
                                 device="cpu").eval(), lv)

    def jax_searcher(self, **kwargs):
        v = self.v

        def pred_step(tokens, hidden):
            out, hidden = self.j_lstm.apply(
                v["lstm"], self.j_emb.apply(v["emb"], tokens), hx=hidden)
            return self.j_proj.apply(v["proj"], out), hidden

        lm = None
        if self.j_lm is not None:
            lm = jax.jit(lambda tok, h: self.j_lm.apply(v["lm"], tok, hx=h))
        # jitted: the beam search calls them one hypothesis at a time
        return JaxSearcher(
            jax.jit(pred_step),
            jax.jit(lambda a, b: self.j_joint.apply(v["joint"], a, b)),
            jax.jit(lambda x: self.j_out.apply(v["out"], x)), blank_id=0,
            lm_module=lm, **kwargs)

    def searcher(self, **kwargs):
        def pred_step(tokens, hidden):
            out, hidden = self.lstm(self.emb(tokens), hidden)
            return self.proj(out), hidden

        return TransducerBeamSearcher(pred_step, self.joint, self.out,
                                      blank_id=0, lm_module=self.lm,
                                      **kwargs)


def _enc(seed=20, batch=B, frames=T):
    return _np((batch, frames, J_ENC), seed)


@pytest.fixture(scope="module")
def nets():
    return Nets()


def test_greedy_matches_jax(nets):
    enc = _enc()
    want, *_ = nets.jax_searcher(beam_size=1, max_symbols_per_step=3)(
        jnp.asarray(enc))
    got, scores, _, _ = nets.searcher(beam_size=1, max_symbols_per_step=3)(
        torch.from_numpy(enc))
    assert got == want and scores is None
    lens = [len(h) for h in got]
    # the rows emit labels, and blanks end some frames early
    assert all(0 < n < T * 3 for n in lens)


def test_streaming_greedy_over_two_chunks_matches_jax(nets):
    enc = _enc(seed=21)
    jsearch = nets.jax_searcher(beam_size=1, max_symbols_per_step=3)
    search = nets.searcher(beam_size=1, max_symbols_per_step=3)
    jctx, ctx = JaxContext(), TransducerGreedySearcherStreamingContext()
    for chunk in (slice(0, 4), slice(4, T)):
        want = jsearch.transducer_greedy_decode_streaming(
            jnp.asarray(enc[:, chunk]), jctx)
        got = search.transducer_greedy_decode_streaming(
            torch.from_numpy(np.ascontiguousarray(enc[:, chunk])), ctx)
        assert got == want
    assert ctx.last_token.tolist() == np.asarray(jctx.last_token).tolist()
    for ours, ref in zip(ctx.hidden, jctx.hidden):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=JOINT_ATOL)
    # the second chunk continues the first: the whole sequence at once
    whole, *_ = search(torch.from_numpy(enc))
    first = nets.searcher(beam_size=1, max_symbols_per_step=3)
    ctx2 = TransducerGreedySearcherStreamingContext()
    parts = [first.transducer_greedy_decode_streaming(
        torch.from_numpy(np.ascontiguousarray(enc[:, c])), ctx2)
        for c in (slice(0, 4), slice(4, T))]
    assert [a + b for a, b in zip(*parts)] == whole


@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_matches_jax(with_lm):
    nets = Nets(seed=30, lm=with_lm)
    enc = _enc(seed=22, batch=2, frames=4)
    kwargs = dict(beam_size=3, nbest=2, lm_weight=0.5 if with_lm else 0.0)
    want = nets.jax_searcher(**kwargs)(jnp.asarray(enc))
    got = nets.searcher(**kwargs)(torch.from_numpy(enc))
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert all(len(n) == 2 for n in got[2])
    np.testing.assert_allclose(got[1], want[1], atol=SCORE_ATOL)
    np.testing.assert_allclose(np.array(got[3]), np.array(want[3]),
                               atol=SCORE_ATOL)


def test_beam_with_lm_differs_from_without():
    """The fusion is on: the same search with the LM at weight 0.5 scores
    its hypotheses otherwise than at weight 0."""
    nets = Nets(seed=30, lm=True)
    enc = torch.from_numpy(_enc(seed=22, batch=2, frames=4))
    fused = nets.searcher(beam_size=3, nbest=2, lm_weight=0.5)(enc)
    plain = nets.searcher(beam_size=3, nbest=2, lm_weight=0.0)(enc)
    assert fused[3] != plain[3]


def test_greedy_masks_the_batch_axis_of_a_layered_state():
    """C33. With a 2-layer LSTM at batch 2 the state is (2, 2, H): the JAX
    searcher takes its first axis for the batch and keeps or replaces
    layers by the rows' blank flags. The port masks the batch axis: its
    batched tokens and final state equal each utterance decoded alone
    (batch 1, where the two readings agree); JAX's batched state does not,
    and here its tokens do not either."""
    nets = Nets(layers=2, seed=40, blank_bias=0.5)
    enc = _enc(seed=23, batch=2, frames=8)
    kw = dict(beam_size=1, max_symbols_per_step=3)

    def jax_run(x):
        hyps, _, _, _, (_, (h, c)) = nets.jax_searcher(
            **kw).transducer_greedy_decode(jnp.asarray(x), return_hidden=True)
        return hyps, np.concatenate([np.asarray(h), np.asarray(c)])

    def run(x):
        hyps, _, _, _, (_, (h, c)) = nets.searcher(
            **kw).transducer_greedy_decode(torch.from_numpy(x),
                                           return_hidden=True)
        return hyps, torch.cat([h, c]).numpy()

    alone = [jax_run(enc[b:b + 1]) for b in range(2)]
    alone_hyps = [hyps[0] for hyps, _ in alone]
    alone_state = np.concatenate([state for _, state in alone], axis=1)
    ours_alone = [run(enc[b:b + 1])[0][0] for b in range(2)]
    ours, ours_state = run(enc)
    jax_hyps, jax_state = jax_run(enc)
    assert ours_alone == alone_hyps
    assert ours == alone_hyps
    np.testing.assert_allclose(ours_state, alone_state, atol=JOINT_ATOL)
    assert np.abs(jax_state - alone_state).max() > 1e-2
    assert jax_hyps != alone_hyps
