"""The recurrent family's layers against the JAX package at a small size:
``LSTM``, ``GRU``, ``RNN``, ``LiGRU``, ``SLiGRU``, ``QuasiRNN`` (uni- and
bidirectional, with an initial state), their gradients, ``BatchNorm1d``/
``BatchNorm2d`` with their running statistics, ``Pooling1d``/``Pooling2d``,
the dropouts' masks, the three seq2seq attentions and the
``AttentionalRNNDecoder``. Weights are drawn with numpy into the shapes of
flax's variables (``jax.eval_shape`` of its init) and carried into the port
through ``utils/jax_bridge``; inputs come from numpy.

Tolerances: 1e-5 absolute on outputs and gradients (float32 on both sides,
sums in another order); 1e-6 on running statistics."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.nnet import RNN as jrnn
from speechbrain_tpu.nnet import attention as jattn
from speechbrain_tpu.nnet.normalization import BatchNorm1d as JaxBN1d
from speechbrain_tpu.nnet.normalization import BatchNorm2d as JaxBN2d
from speechbrain_tpu.nnet.pooling import Pooling1d as JaxPool1d
from speechbrain_tpu.nnet.pooling import Pooling2d as JaxPool2d
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet import RNN as trnn
from speechbrain_tpu_torch.nnet import attention as tattn
from speechbrain_tpu_torch.nnet.dropout import Dropout2d
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d, BatchNorm2d
from speechbrain_tpu_torch.nnet.pooling import Pooling1d, Pooling2d
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-5
STATS_ATOL = 1e-6
KEY = jax.random.PRNGKey(0)
B, T, F_IN, H = 3, 7, 6, 5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(
        torch_out.detach().numpy(), np.asarray(jax_out), atol=atol
    )


def draw_variables(module, *args, seed=1, **kwargs):
    """Random variables (every collection) in the shapes of
    ``module.init(KEY, *args, **kwargs)`` (:func:`draw_from_shapes`)."""
    shapes = jax.eval_shape(lambda *a: module.init(KEY, *a, **kwargs), *args)
    return draw_from_shapes(shapes, seed)


def draw_from_shapes(shapes, seed=1):
    """Numpy leaves in the shapes of a traced variable tree: scales about
    1, running variances in [1, 1.5), kernels and recurrent matrices
    N(0, 1/fan_in), embeddings N(0, 1), everything else about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return (1.0 + 0.5 * rng.random(leaf.shape)).astype(np.float32)
        if name == "embedding":
            return n
        if name == "kernel" or name.startswith("wh_"):
            fan_in = np.prod(leaf.shape[:-1])
            return n / np.sqrt(fan_in)
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def japply(module, variables, *args, **kwargs):
    """``module.apply`` compiled as one program (about half the time of
    running it op by op)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        _jax(variables), *args
    )


# -- recurrent layers --------------------------------------------------------

RNN_CASES = {
    "lstm": (jrnn.LSTM, trnn.LSTM, {}),
    "gru": (jrnn.GRU, trnn.GRU, {}),
    "rnn_tanh": (jrnn.RNN, trnn.RNN, {"nonlinearity": "tanh"}),
    "rnn_relu": (jrnn.RNN, trnn.RNN, {"nonlinearity": "relu"}),
    "ligru": (jrnn.LiGRU, trnn.LiGRU, {}),
    "ligru_layernorm": (jrnn.LiGRU, trnn.LiGRU,
                        {"normalization": "layernorm"}),
    "sligru": (jrnn.SLiGRU, trnn.SLiGRU, {}),
}


def _hx(name, n):
    rng = np.random.default_rng(5)
    h = (0.5 * rng.standard_normal((n, B, H))).astype(np.float32)
    if name == "lstm":
        return h, (0.5 * rng.standard_normal((n, B, H))).astype(np.float32)
    return h


def _pair(name, bidirectional):
    layers = 2 if bidirectional else 1
    jcls, tcls, extra = RNN_CASES[name]
    jnet = jcls(hidden_size=H, num_layers=layers,
                bidirectional=bidirectional, **extra)
    x = _x((B, T, F_IN))
    variables = draw_variables(jnet, jnp.asarray(x), train=False)
    tnet = tcls(hidden_size=H, input_size=F_IN, num_layers=layers,
                bidirectional=bidirectional, device="cpu", **extra)
    load(tnet, variables)
    return jnet, tnet, variables, x


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("name", list(RNN_CASES))
def test_rnn_layers_match_jax(name, bidirectional):
    jnet, tnet, variables, x = _pair(name, bidirectional)
    hx = _hx(name, tnet.num_layers * tnet.dirs)
    j_out, j_h = japply(jnet, variables, jnp.asarray(x),
                        jax.tree_util.tree_map(jnp.asarray, hx), train=False)
    t_hx = tuple(map(_t, hx)) if isinstance(hx, tuple) else _t(hx)
    t_out, t_h = tnet.eval()(_t(x), t_hx)
    _close(t_out, j_out)
    for t_leaf, j_leaf in zip(jax.tree_util.tree_leaves(t_h),
                              jax.tree_util.tree_leaves(j_h)):
        _close(t_leaf, j_leaf)
    if bidirectional:  # and from a zero state
        _close(tnet(_t(x))[0],
               japply(jnet, variables, jnp.asarray(x), train=False)[0])


@pytest.mark.parametrize("name", ["ligru", "sligru"])
def test_ligru_training_mode_uses_batch_statistics(name):
    """In training the LiGRU normalises its projection with the batch's
    statistics and moves its running statistics as flax does."""
    jnet, tnet, variables, x = _pair(name, True)
    (j_out, _), j_new = japply(jnet, variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    t_out, _ = tnet.train()(_t(x))
    _close(t_out, j_out)
    stats = j_new["batch_stats"]
    for layer in range(2):
        for d in range(2):
            bn = tnet.norm[tnet.index(layer, d)]
            j_bn = stats[f"norm_l{layer}_d{d}"]["BatchNorm_0"]
            _close(bn.running_mean, j_bn["mean"], STATS_ATOL)
            _close(bn.running_var, j_bn["var"], STATS_ATOL)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
def test_quasi_rnn_matches_jax(bidirectional):
    jnet = jrnn.QuasiRNN(hidden_size=H, num_layers=2, kernel_size=3,
                         bidirectional=bidirectional)
    x = _x((B, T, F_IN))
    variables = draw_variables(jnet, jnp.asarray(x))
    tnet = trnn.QuasiRNN(hidden_size=H, input_size=F_IN, num_layers=2,
                         kernel_size=3, bidirectional=bidirectional,
                         device="cpu")
    load(tnet, variables)
    j_out, j_h = japply(jnet, variables, jnp.asarray(x))
    t_out, t_h = tnet(_t(x))
    _close(t_out, j_out)
    _close(t_h, j_h)


def _grad_map(name, tnet, layers, dirs):
    """(torch parameter, path in the flax tree, transposed) per weight."""
    pairs = []
    for layer in range(layers):
        for d in range(dirs):
            i, tag = tnet.index(layer, d), f"l{layer}_d{d}"
            pairs.append((tnet.wx[i].weight, (f"wx_{tag}", "kernel"), True))
            if tnet.wx[i].bias is not None:
                pairs.append((tnet.wx[i].bias, (f"wx_{tag}", "bias"), False))
            pairs.append((tnet.wh[i], (f"wh_{tag}",), True))
            if name == "ligru":
                bn = tnet.norm[i]
                pairs.append((bn.weight,
                              (f"norm_{tag}", "BatchNorm_0", "scale"),
                              False))
    return pairs


@pytest.mark.parametrize("name", ["lstm", "ligru"])
def test_rnn_gradients_match_jax_grad(name):
    """The gradient of a weighted sum of the outputs with respect to the
    input and every weight, against ``jax.grad`` (the LiGRU in training
    mode, through its batch statistics)."""
    jnet, tnet, variables, x = _pair(name, True)
    w = _x((B, T, 2 * H), seed=9)
    params = _jax(variables["params"])
    others = {k: _jax(v) for k, v in variables.items() if k != "params"}

    def loss(p, xs):
        out = jnet.apply({"params": p, **others}, xs, train=True,
                         mutable=["batch_stats"])[0][0]
        return jnp.sum(out * w)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(x)
    )
    xt = _t(x).requires_grad_(True)
    (tnet.train()(xt)[0] * _t(w)).sum().backward()
    _close(xt.grad, g_x)
    for param, path, transposed in _grad_map(name, tnet, 2, 2):
        g = g_params
        for key in path:
            g = g[key]
        g = np.asarray(g)
        _close(param.grad, g.T if transposed else g)


# -- BatchNorm ---------------------------------------------------------------

@pytest.mark.parametrize("rank", [3, 4])
def test_batchnorm_output_and_running_stats_match_flax(rank):
    """Three training updates, each on a new batch, then evaluation: the
    outputs at every update and the running mean and (biased) variance
    after each against flax's."""
    shape = (4, 6, 5) if rank == 3 else (2, 6, 3, 5)
    jbn = JaxBN1d() if rank == 3 else JaxBN2d()
    tbn = (BatchNorm1d if rank == 3 else BatchNorm2d)(5, device="cpu")
    x0 = _x(shape)
    variables = draw_variables(jbn, jnp.asarray(x0), train=False)
    load(tbn, variables)
    j_vars = _jax(variables)
    tbn.train()
    for step in range(3):
        # an offset and a spread so that biased and unbiased differ
        x = 2.0 + 3.0 * _x(shape, seed=10 + step)
        j_out, upd = japply(jbn, j_vars, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        j_vars = {**j_vars, **upd}
        _close(tbn(_t(x)), j_out)
        j_bn = j_vars["batch_stats"]["BatchNorm_0"]
        _close(tbn.running_mean, j_bn["mean"], STATS_ATOL)
        _close(tbn.running_var, j_bn["var"], STATS_ATOL)
    x = _x(shape, seed=20)
    _close(tbn.eval()(_t(x)), japply(jbn, j_vars, jnp.asarray(x),
                                     train=False))


# -- pooling -----------------------------------------------------------------

@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,padding",
                         [(3, None, 0), (2, 1, 0), (3, 2, 1), (4, None, 0)])
def test_pooling1d_matches_jax(pool_type, kernel, stride, padding):
    x = _x((2, 11, 4))
    j = JaxPool1d(pool_type, kernel, stride, padding).apply({}, jnp.asarray(x))
    t = Pooling1d(pool_type, kernel, stride, padding)(_t(x))
    _close(t, j)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("kernel,rank", [((1, 2), 4), ((2, 2), 4),
                                          ((4, 1), 4), ((3, 2), 3)])
def test_pooling2d_matches_jax(pool_type, kernel, rank):
    x = _x((2, 9, 7, 3)[:rank])
    j = JaxPool2d(pool_type, kernel).apply({}, jnp.asarray(x))
    t = Pooling2d(pool_type, kernel)(_t(x))
    _close(t, j)


# -- dropouts ----------------------------------------------------------------

def test_dropout_masks_have_their_shapes():
    """``Dropout2d`` draws one mask per (batch, channel), shared over time;
    the CRDNN's CNN-block dropout one per (batch, time, feature), shared by
    every channel (flax's ``Dropout(broadcast_dims=(3,))``)."""
    torch.manual_seed(0)
    drop = Dropout2d(drop_rate=0.5).train()
    y = drop(torch.ones(4, 10, 8))
    assert (y == y[:, :1]).all()
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(Dropout2d(0.5).eval()(torch.ones(2, 3, 4)),
                       torch.ones(2, 3, 4))
    crdnn = CRDNN(input_size=8, dropout=0.5, device="cpu").train()
    y = crdnn._drop(torch.ones(3, 10, 8, 16), channel_shared=True)
    assert (y == y[..., :1]).all()
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 0 < (y[..., 0] == 0).float().mean() < 1


# -- attention ---------------------------------------------------------------

ENC, DEC, ATT, OUT = 6, 7, 5, 4
LENS = np.array([1.0, 0.6, 0.35], np.float32)


def _attention_pair(kind):
    enc, dec = _x((B, T, ENC)), _x((B, DEC), seed=2)
    if kind == "content":
        jm = jattn.ContentBasedAttention(attn_dim=ATT, output_dim=OUT,
                                         scaling=1.3)
        tm = tattn.ContentBasedAttention(ENC, DEC, ATT, OUT, scaling=1.3,
                                         device="cpu")
    elif kind == "location":
        jm = jattn.LocationAwareAttention(attn_dim=ATT, output_dim=OUT,
                                          conv_channels=3, kernel_size=4,
                                          scaling=1.3)
        tm = tattn.LocationAwareAttention(ENC, DEC, ATT, OUT,
                                          conv_channels=3, kernel_size=4,
                                          scaling=1.3, device="cpu")
    else:
        jm = jattn.KeyValueAttention(attn_dim=ATT, output_dim=OUT)
        tm = tattn.KeyValueAttention(ENC, DEC, ATT, OUT, device="cpu")
    args = (jnp.asarray(enc), jnp.asarray(LENS), jnp.asarray(dec))
    variables = draw_variables(jm, *args)
    load(tm, variables)
    return jm, tm, _jax(variables), enc, dec


@pytest.mark.parametrize("kind", ["content", "location", "keyvalue"])
def test_attentions_match_jax(kind):
    jm, tm, variables, enc, dec = _attention_pair(kind)
    args = (jnp.asarray(enc), jnp.asarray(LENS), jnp.asarray(dec))
    targs = (_t(enc), _t(LENS), _t(dec))
    j_ctx, j_w = japply(jm, variables, *args)
    t_ctx, t_w = tm(*targs)
    _close(t_ctx, j_ctx)
    _close(t_w, j_w)
    # padded frames get no weight
    assert float(t_w[2, 3:].abs().max().detach()) == 0.0
    if kind == "location":
        prev = np.abs(_x((B, T), seed=4))
        j_ctx, j_w = japply(jm, variables, *args, jnp.asarray(prev))
        t_ctx, t_w = tm(*targs, prev_attn=_t(prev))
        _close(t_ctx, j_ctx)
        _close(t_w, j_w)


# -- the decoder -------------------------------------------------------------

@pytest.mark.parametrize("attn_type,layers", [("location", 1),
                                              ("content", 2),
                                              ("keyvalue", 1)])
def test_attentional_rnn_decoder_matches_jax(attn_type, layers):
    E, U = 4, 5
    jdec = jrnn.AttentionalRNNDecoder(hidden_size=H + 1, attn_dim=ATT,
                                      num_layers=layers, attn_type=attn_type,
                                      channels=3, kernel_size=2)
    tdec = trnn.AttentionalRNNDecoder(hidden_size=H + 1, attn_dim=ATT,
                                      input_size=E, enc_dim=ENC,
                                      num_layers=layers, attn_type=attn_type,
                                      channels=3, kernel_size=2,
                                      device="cpu")
    inp, enc = _x((B, U, E), seed=3), _x((B, T, ENC))
    jargs = (jnp.asarray(inp), jnp.asarray(enc), jnp.asarray(LENS))
    variables = draw_variables(jdec, *jargs)
    load(tdec, variables)
    variables = _jax(variables)
    j_out, j_attn = japply(jdec, variables, *jargs)
    t_out, t_attn = tdec(_t(inp), _t(enc), _t(LENS))
    _close(t_out, j_out)
    _close(t_attn, j_attn)
    # one step from a state that is not the first
    rng = np.random.default_rng(8)
    state = {
        "hidden": rng.standard_normal((B, layers, H + 1)).astype(np.float32),
        "context": rng.standard_normal((B, ATT)).astype(np.float32),
        "prev_attn": np.abs(rng.standard_normal((B, T))).astype(np.float32),
    }
    j_o, j_s, j_a = japply(
        jdec, variables, jnp.asarray(inp[:, 0]),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(enc),
        jnp.asarray(LENS), method="forward_step",
    )
    t_o, t_s, t_a = tdec.forward_step(
        _t(inp[:, 0]), {k: _t(v) for k, v in state.items()}, _t(enc),
        _t(LENS),
    )
    _close(t_o, j_o)
    _close(t_a, j_a)
    for key in ("hidden", "context", "prev_attn"):
        _close(t_s[key], j_s[key])
