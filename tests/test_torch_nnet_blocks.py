"""The nnet building blocks of this slice against the JAX package, at a
small size, with weights drawn with numpy and bridged: ``Softmax`` (with
lengths, log, another axis), ``GumbelSoftmax`` (soft, hard and log, the
uniform draws handed to both packages through the patched draw helpers),
``Swish``, ``InstanceNorm2d``, ``SincConv`` (its initial cut-offs, then
moved ones, "same" and "valid"), ``Conv1d(weight_norm=True)`` (accepted and
not read, as in JAX), ``Linear(max_norm=)`` and
``Embedding(consider_as_one_hot=True)``. Tolerance 1e-5 absolute (float32
on both sides); 1e-4 relative to the largest output for ``SincConv``, whose
taps reach a few hundred.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.nnet import activations as jact
from speechbrain_tpu.nnet.CNN import Conv1d as JaxConv1d
from speechbrain_tpu.nnet.CNN import SincConv as JaxSincConv
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.normalization import (
    InstanceNorm2d as JaxInstanceNorm2d,
)
from speechbrain_tpu_torch.nnet import activations as tact
from speechbrain_tpu_torch.nnet.CNN import Conv1d, SincConv
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import InstanceNorm2d
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _close, _t, _x, draw_variables, japply
from test_torch_ssl import SameDraws

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("apply_log", [False, True])
@pytest.mark.parametrize("axis", [-1, 2])
def test_softmax_matches_jax(apply_log, axis):
    x = _x((3, 6, 5, 4))
    lengths = np.array([1.0, 0.5, 0.25], np.float32)
    jm = jact.Softmax(apply_log=apply_log, axis=axis)
    tm = tact.Softmax(apply_log=apply_log, axis=axis)
    for lens in (None, lengths):
        ref = np.asarray(jm.apply({}, jnp.asarray(x),
                                  None if lens is None else jnp.asarray(lens)))
        out = tm(_t(x), None if lens is None else _t(lens)).numpy()
        np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out[fin], ref[fin], atol=1e-5)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("apply_log", [False, True])
def test_gumbel_softmax_matches_jax_on_the_same_draws(monkeypatch, hard,
                                                      apply_log):
    x = _x((4, 3, 7), seed=1)
    draws = SameDraws(monkeypatch)
    draws.add_uniform(x.shape, seed=2)
    draws.install()
    jm = jact.GumbelSoftmax(tau=0.7, hard=hard, apply_log=apply_log)
    ref = jm.apply({}, jnp.asarray(x), rngs={"gumbel": KEY})
    tm = tact.GumbelSoftmax(tau=0.7, hard=hard, apply_log=apply_log)
    xt = _t(x).requires_grad_(True)
    out = tm(xt, generator=torch.Generator().manual_seed(0))
    _close(out, ref)
    if hard and not apply_log:
        # one-hot forward, the soft sample's gradient backward
        assert torch.equal(out.detach().sum(-1), torch.ones(4, 3))
        grad, = torch.autograd.grad((out * _t(_x(x.shape, 3))).sum(), xt)
        jgrad = jax.grad(lambda v: jnp.sum(
            jm.apply({}, v, rngs={"gumbel": KEY}) * jnp.asarray(
                _x(x.shape, 3))))(jnp.asarray(x))
        _close(grad, jgrad)


def test_gumbel_softmax_draws_from_its_generator():
    tm = tact.GumbelSoftmax()
    x = torch.zeros(2, 9)
    a = tm(x, generator=torch.Generator().manual_seed(4))
    b = tm(x, generator=torch.Generator().manual_seed(4))
    c = tm(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_swish_matches_jax():
    x = _x((2, 5), seed=4)
    for beta in (1.0, 0.5):
        _close(tact.Swish(beta)(_t(x)),
               jact.Swish(beta).apply({}, jnp.asarray(x)))


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_2d_matches_jax(affine):
    x = 3.0 * _x((2, 7, 5, 4), seed=5) + 1.0
    jm = JaxInstanceNorm2d(affine=affine)
    variables = draw_variables(jm, jnp.asarray(x), seed=6)
    tm = load(InstanceNorm2d(4, affine=affine, device="cpu"), variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))


@pytest.mark.parametrize("padding,stride", [("same", 1), ("valid", 2)])
def test_sinc_conv_matches_jax(padding, stride):
    x = _x((2, 400, 1), seed=7)
    kw = dict(out_channels=6, kernel_size=31, stride=stride, padding=padding,
              sample_rate=8000)
    jm = JaxSincConv(**kw)
    init = jax.tree_util.tree_map(np.asarray, jm.init(KEY, jnp.asarray(x)))
    tm = SincConv(**kw, device="cpu")
    # the port's initial cut-offs are JAX's
    np.testing.assert_allclose(tm.low_hz.detach().numpy(),
                               init["params"]["low_hz"], rtol=1e-6)
    np.testing.assert_allclose(tm.band_hz.detach().numpy(),
                               init["params"]["band_hz"], rtol=1e-6)
    rng = np.random.default_rng(8)
    moved = {"params": {
        k: (v + rng.normal(0, 40, v.shape)).astype(np.float32)
        for k, v in init["params"].items()}}
    load(tm, moved)
    ref = np.asarray(japply(jm, moved, jnp.asarray(x)))
    out = tm(_t(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())
    # a (batch, time) waveform is one channel
    np.testing.assert_array_equal(tm(_t(x[..., 0])).detach().numpy(), out)
    with pytest.raises(ValueError, match="odd"):
        SincConv(4, 30, device="cpu")


def test_conv1d_weight_norm_is_accepted_and_not_read():
    x = _x((2, 12, 3), seed=9)
    jm = JaxConv1d(out_channels=5, kernel_size=3, weight_norm=True)
    variables = draw_variables(jm, jnp.asarray(x), seed=10)
    assert set(variables["params"]) == {"kernel", "bias"}
    tm = load(Conv1d(5, 3, in_channels=3, weight_norm=True, device="cpu"),
              variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))
    plain = load(Conv1d(5, 3, in_channels=3, device="cpu"), variables)
    assert torch.equal(tm(_t(x)), plain(_t(x)))


@pytest.mark.parametrize("max_norm", [None, 0.8, 100.0])
def test_linear_max_norm_matches_jax(max_norm):
    x = _x((3, 4, 6), seed=11)
    jm = JaxLinear(n_neurons=5, max_norm=max_norm)
    variables = draw_variables(jm, jnp.asarray(x), seed=12)
    tm = load(Linear(5, 6, max_norm=max_norm, device="cpu"), variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))
    if max_norm == 0.8:
        # some rows were over the norm: the stored weight is untouched
        norms = torch.linalg.vector_norm(tm.weight, dim=1)
        assert (norms > 0.8).any()
        np.testing.assert_array_equal(
            tm.weight.detach().numpy(),
            np.asarray(variables["params"]["kernel"], np.float32).T)


@pytest.mark.parametrize("blank_id", [0, 3])
def test_one_hot_embedding_matches_jax(blank_id):
    ids = np.array([[0, 1, 3], [4, 2, 2]], np.int32)
    jm = JaxEmbedding(num_embeddings=5, consider_as_one_hot=True,
                      blank_id=blank_id)
    ref = jm.apply({}, jnp.asarray(ids))
    tm = Embedding(5, consider_as_one_hot=True, blank_id=blank_id,
                   device="cpu")
    assert tm.weight is None and not tm.state_dict()
    load(tm, {"params": {}})
    _close(tm(_t(ids)), ref)
