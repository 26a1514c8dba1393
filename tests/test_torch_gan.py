"""The GAN slice's modules against the JAX package at a tiny width, the
same numpy inputs through both, the JAX weights (drawn with numpy into
the shapes of flax's variables) carried over by ``utils/jax_bridge``:

* ``segan_model.Generator`` with the latent off, then with one ``z``
  handed to both (JAX's draw patched to return it), and the port's own
  draw from a ``torch.Generator``; ``segan_model.Discriminator``;
* ``LearnableSigmoid``, ``EnhancementGenerator``, both
  ``MetricDiscriminator`` classes in training mode (their running
  statistics too) and in evaluation mode;
* ``srmr_batch`` and ``srmr_batch_normalized`` on arrays and tensors;
* ``Brain.make_gan_steps`` against a two-optimizer reference built here
  from the JAX MetricGAN recipe's own loss functions and ``jax.grad``,
  one ``optax.adam`` state a group: every parameter and the
  discriminator's running statistics after a D, a G and a D step;
* C50: JAX's ``make_gan_steps``, one Adam over both groups, moves the
  discriminator on a generator step; the port's leaves its parameters,
  its optimizer's state and its BatchNorm buffers bit for bit, and a D
  step leaves the generator's the same;
* both optimizers saved and recovered by the checkpointer under their
  own names; a dict ``opt_class`` stepped together by ``fit``.

Tolerance: 1e-5 relative L2 for module outputs in float32, 1e-6
absolute for running statistics, 1e-6 relative for SRMR (the same
float64 arithmetic), 2e-6 absolute for parameters after three Adam
steps at a rate of 1e-3 (each update is about the rate, whatever the
gradient's scale)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from speechbrain_tpu.lobes.models import MetricGAN as jmg
from speechbrain_tpu.lobes.models import MetricGAN_U as jmgu
from speechbrain_tpu.lobes.models import segan_model as jseg
from speechbrain_tpu.processing import srmr as jsrmr
from speechbrain_tpu_torch.core import Brain, forward_with_frozen_buffers
from speechbrain_tpu_torch.lobes.models import MetricGAN as tmg
from speechbrain_tpu_torch.lobes.models import MetricGAN_U as tmgu
from speechbrain_tpu_torch.lobes.models import segan_model as tseg
from speechbrain_tpu_torch.processing import srmr as tsrmr
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN import (
    train as metricgan,
)
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_from_shapes

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
STATS_ATOL = 1e-6
SRMR_RTOL = 1e-6
PARAM_ATOL = 2e-6
LR = 1e-3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def variables_of(jm, *args, seed=1, rngs=None, **kwargs):
    """Numpy variables in the shapes of ``jm.init(*args)``."""
    shapes = jax.eval_shape(lambda: jm.init(
        rngs or jax.random.PRNGKey(0), *args, **kwargs))
    return draw_from_shapes(shapes, seed=seed)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rand(*shape, seed=0, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) if positive else x


# -- the models --------------------------------------------------------------

SEGAN = dict(kernel_size=8, channels=(4, 8, 8))


def test_segan_generator_without_latent_matches_jax():
    x = _rand(2, 256, seed=1)
    jm = jseg.Generator(latent_noise=False, **SEGAN)
    v = variables_of(jm, jnp.asarray(x))
    tm = load(tseg.Generator(latent_noise=False, device="cpu", **SEGAN), v)
    want = jm.apply(_jax(v), jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 256)
    assert rel_l2(got.detach(), want) <= RTOL


def test_segan_generator_with_a_shared_latent_matches_jax(monkeypatch):
    """One ``z`` through both: JAX's draw patched to return numpy's draw
    in the shape it asks for, the port given the same; (B, T, 1) inputs
    keep their channel axis."""
    x = _rand(2, 256, 1, seed=2)
    jm = jseg.Generator(**SEGAN)
    key = jax.random.PRNGKey(0)
    v = variables_of(jm, jnp.asarray(x), rngs={"params": key, "noise": key})
    tm = load(tseg.Generator(device="cpu", **SEGAN), v)
    drawn = []

    def normal(rng, shape, *args, **kwargs):
        drawn.append(_rand(*shape, seed=3))
        return jnp.asarray(drawn[-1])

    monkeypatch.setattr(jax.random, "normal", normal)
    want = jm.apply(_jax(v), jnp.asarray(x), rngs={"noise": key})
    assert len(drawn) == 1 and drawn[0].shape[-1] == SEGAN["channels"][-1]
    got = tm(torch.from_numpy(x), z=torch.from_numpy(drawn[0]))
    assert got.shape == (2, 256, 1)
    assert rel_l2(got.detach(), want) <= RTOL


def test_segan_generator_draws_its_latent_from_the_generator_given():
    tm = tseg.Generator(device="cpu", **SEGAN)
    x = torch.from_numpy(_rand(2, 256, seed=4))
    draw = lambda s: tm(x, generator=torch.Generator().manual_seed(s))  # noqa
    with torch.no_grad():
        assert torch.equal(draw(5), draw(5))
        assert not torch.equal(draw(5), draw(6))


def test_segan_discriminator_matches_jax():
    x = _rand(2, 256, 2, seed=5)
    jm = jseg.Discriminator(kernel_size=8, channels=(4, 8))
    v = variables_of(jm, jnp.asarray(x))
    tm = load(tseg.Discriminator(kernel_size=8, channels=(4, 8),
                                 device="cpu"), v)
    want = jm.apply(_jax(v), jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 1)
    assert rel_l2(got.detach(), want) <= RTOL


def test_learnable_sigmoid_matches_jax():
    x = _rand(2, 3, 5, seed=6)
    jm = jmg.LearnableSigmoid(in_features=5)
    v = variables_of(jm, jnp.asarray(x), seed=7)
    tm = load(tmg.LearnableSigmoid(5, device="cpu"), v)
    assert rel_l2(tm(torch.from_numpy(x)).detach(),
                  jm.apply(_jax(v), jnp.asarray(x))) <= RTOL


def test_enhancement_generator_matches_jax():
    x = _rand(2, 12, 17, seed=8, positive=True)
    jm = jmg.EnhancementGenerator(lstm_neurons=8, dnn_neurons=6)
    v = variables_of(jm, jnp.asarray(x))
    tm = load(tmg.EnhancementGenerator(8, 6, n_freq=17, device="cpu"), v)
    tm.eval()
    want = jm.apply(_jax(v), jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 12, 17)
    assert rel_l2(got.detach(), want) <= RTOL


DISCRIMINATORS = {
    "MetricGAN": (lambda: jmg.MetricDiscriminator(base_channels=4),
                  lambda: tmg.MetricDiscriminator(base_channels=4,
                                                  device="cpu"),
                  (2, 12, 17, 2)),
    "MetricGAN_U": (lambda: jmgu.MetricDiscriminator(base_channels=4),
                    lambda: tmgu.MetricDiscriminator(base_channels=4,
                                                     device="cpu"),
                    (2, 12, 17)),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(DISCRIMINATORS))
def test_metric_discriminator_matches_jax(name, train):
    """Training mode: the batch's statistics over batch, time and
    frequency (the 4-D input through the port's ``BatchNorm1d``), and the
    running statistics moved as flax moves them; evaluation mode: the
    running statistics normalise."""
    make_jax, make_torch, shape = DISCRIMINATORS[name]
    x = _rand(*shape, seed=9, positive=True)
    jm = make_jax()
    v = variables_of(jm, jnp.asarray(x), train=False)
    tm = load(make_torch(), v)
    if train:
        want, updates = jm.apply(_jax(v), jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        got = tm.train()(torch.from_numpy(x))
        stats = updates["batch_stats"]["bn_in"]["BatchNorm_0"]
        np.testing.assert_allclose(tm.bn_in.running_mean.numpy(),
                                   stats["mean"], atol=STATS_ATOL)
        np.testing.assert_allclose(tm.bn_in.running_var.numpy(),
                                   stats["var"], atol=STATS_ATOL)
    else:
        want = jm.apply(_jax(v), jnp.asarray(x), train=False)
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (2, 1)
    assert rel_l2(got.detach(), want) <= RTOL


def _srmr_batch_input():
    rng = np.random.default_rng(10)
    t = np.arange(12000) / 16000
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t)
    clean = 0.5 * am * np.sin(2 * np.pi * 300 * t)
    wavs = np.stack([clean, clean + 0.1 * rng.standard_normal(len(t)),
                     rng.standard_normal(len(t))]).astype(np.float32)
    return wavs, np.array([1.0, 0.8, 0.5], np.float32)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["arrays", "tensors"])
def test_srmr_matches_jax(as_tensor):
    """Per-utterance lengths; the modulated clean tone scores above the
    noise; a signal shorter than 8 frames scores 0."""
    wavs, lens = _srmr_batch_input()
    args = ((torch.from_numpy(wavs), torch.from_numpy(lens)) if as_tensor
            else (wavs, lens))
    got = tsrmr.srmr_batch(*args)
    want = jsrmr.srmr_batch(wavs, lens)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SRMR_RTOL)
    assert got[0] > got[2]
    np.testing.assert_allclose(tsrmr.srmr_batch_normalized(*args),
                               jsrmr.srmr_batch_normalized(wavs, lens),
                               rtol=SRMR_RTOL)
    assert tsrmr.srmr_ratio(wavs[0, :1000]) == 0.0


# -- the GAN steps -----------------------------------------------------------

N_FREQ = 17


def _jax_metricgan_script():
    spec = importlib.util.spec_from_file_location(
        "jax_metricgan_train",
        ROOT / "recipes/VoiceBank/enhance/MetricGAN/train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gan_batches():
    """The D step's (est, clean, target) and the G step's (noisy,
    clean), numpy."""
    noisy = _rand(2, 10, N_FREQ, seed=11, positive=True)
    clean = _rand(2, 10, N_FREQ, seed=12, positive=True)
    est = 0.5 * noisy
    target = np.array([0.3, 0.7], np.float32)
    return (est, clean, target), (noisy, clean)


def _gan_setup():
    """The JAX MetricGAN recipe's Brain and the twin's, the same drawn
    weights in both (BatchNorm statistics included)."""
    script = _jax_metricgan_script()
    jg = jmg.EnhancementGenerator(lstm_neurons=6, dnn_neurons=5)
    jd = jmg.MetricDiscriminator(base_channels=3)
    x = jnp.zeros((2, 10, N_FREQ))
    vg = variables_of(jg, x, seed=13)
    vd = variables_of(jd, jnp.stack([x, x], -1), train=False, seed=14)
    jb = script.MetricGanBrain(
        modules={"generator": jg, "discriminator": jd}, hparams={},
        run_opts={"jit": False, "noprogressbar": True})
    jb.params = {"generator": _jax(vg["params"]),
                 "discriminator": _jax(vd["params"])}
    jb.model_state = {"batch_stats": {"discriminator":
                                      _jax(vd["batch_stats"])}}
    tg = load(tmg.EnhancementGenerator(6, 5, n_freq=N_FREQ, device="cpu"),
              vg)
    td = load(tmg.MetricDiscriminator(base_channels=3, device="cpu"), vd)
    tb = metricgan.MetricGanBrain(
        modules={"generator": tg, "discriminator": td},
        opt_class=metricgan.adam_groups(LR), hparams={},
        run_opts={"device": "cpu"})
    tb.modules.train()
    return jb, tb


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_params_match(jparams, tb, group):
    """Each JAX parameter against the port's, through the bridge's
    layouts (the port's module loaded with the JAX values and compared
    tensor by tensor)."""
    module = tb.modules[group]
    ref = copy.deepcopy(module)
    load(ref, jax.tree_util.tree_map(np.asarray, jparams[group]))
    for (name, p), q in zip(module.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=PARAM_ATOL, err_msg=f"{group}/{name}")


def test_make_gan_steps_matches_a_two_optimizer_reference():
    """D, G, D steps: the JAX recipe's ``d_loss_fn``/``g_loss_fn``,
    differentiated by ``jax.value_and_grad`` with respect to their own
    group, each group stepped by its own ``optax.adam`` state; the port's
    ``make_gan_steps`` over the twin's loss functions. After each step
    every parameter of both groups within ``PARAM_ATOL``, the losses
    within ``RTOL``, and the discriminator's running statistics (moved
    twice in each D step, not in the G step) within ``STATS_ATOL``."""
    jb, tb = _gan_setup()
    d_batch, g_batch = _gan_batches()
    tx = optax.adam(LR)
    params, state = dict(jb.params), jb.model_state
    opt = {k: tx.init(v) for k, v in params.items()}
    key = jax.random.PRNGKey(0)

    grad_fns = {}

    def ref_step(loss_fn, group, batch):
        nonlocal params, state
        if group not in grad_fns:
            def wrapped(p_group, params, state, batch):
                return loss_fn({**params, group: p_group}, state, batch, key)

            grad_fns[group] = jax.jit(jax.value_and_grad(wrapped,
                                                         has_aux=True))
        (loss, state), grads = grad_fns[group](params[group], params, state,
                                               batch)
        updates, opt[group] = tx.update(grads, opt[group], params[group])
        params = {**params, group: optax.apply_updates(params[group],
                                                       updates)}
        return float(loss)

    d_step, g_step = tb.make_gan_steps(tb.d_loss_fn, tb.g_loss_fn,
                                       "discriminator", "generator")
    t_d = tuple(torch.from_numpy(a) for a in d_batch)
    t_g = tuple(torch.from_numpy(a) for a in g_batch)
    j_d = tuple(jnp.asarray(a) for a in d_batch)
    j_g = tuple(jnp.asarray(a) for a in g_batch)
    for group, (loss_fn, step, jbatch, tbatch) in zip(
            ("discriminator", "generator", "discriminator"),
            ((jb.d_loss_fn, d_step, j_d, t_d),
             (jb.g_loss_fn, g_step, j_g, t_g),
             (jb.d_loss_fn, d_step, j_d, t_d))):
        want = ref_step(loss_fn, group, jbatch)
        got = float(step(tbatch))
        assert got == pytest.approx(want, rel=RTOL)
        for g in ("generator", "discriminator"):
            _assert_params_match(params, tb, g)
        stats = state["batch_stats"]["discriminator"]["bn_in"]["BatchNorm_0"]
        bn = tb.modules.discriminator.bn_in
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   atol=STATS_ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   atol=STATS_ATOL)


def _snapshot(module, optimizer):
    """Copies of a group's parameters, buffers and optimizer state."""
    return ([t.detach().clone() for t in module.state_dict().values()],
            [v.clone() for s in optimizer.state.values()
             for v in s.values() if torch.is_tensor(v)])


def _same(a, b):
    return len(a[0]) == len(b[0]) and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


def test_c50_jax_moves_the_discriminator_on_a_generator_step():
    """C50. JAX's ``make_gan_steps`` runs one Adam over both groups and
    feeds the other group zero gradients: after a D step, the G step
    still moves every discriminator weight that the D step moved (Adam's
    momentum and the shared step count). The port's G step leaves the
    discriminator's parameters, optimizer state and BatchNorm buffers bit
    for bit, and its D step leaves the generator's."""
    jb, tb = _gan_setup()
    d_batch, g_batch = _gan_batches()
    jb.opt_class = lambda: optax.adam(LR)
    jb.init_optimizers()
    jd_step, jg_step = jb.make_gan_steps(jb.d_loss_fn, jb.g_loss_fn,
                                         "discriminator", "generator")
    key = jax.random.PRNGKey(0)
    params, state, opt_state, _ = jd_step(
        jb.params, jb.model_state, jb.opt_state,
        tuple(jnp.asarray(a) for a in d_batch), key)
    after_d = _flat(params["discriminator"])
    params, state, opt_state, _ = jg_step(
        params, state, opt_state, tuple(jnp.asarray(a) for a in g_batch),
        key)
    after_g = _flat(params["discriminator"])
    moved = {k: float(np.abs(after_g[k] - after_d[k]).max())
             for k in after_d}
    assert max(moved.values()) > 0.1 * LR, moved

    d_step, g_step = tb.make_gan_steps(tb.d_loss_fn, tb.g_loss_fn,
                                       "discriminator", "generator")
    opts = tb.optimizers_dict
    g_before = _snapshot(tb.modules.generator, opts["generator"])
    d_step(tuple(torch.from_numpy(a) for a in d_batch))
    assert _same(_snapshot(tb.modules.generator, opts["generator"]),
                 g_before)
    d_before = _snapshot(tb.modules.discriminator, opts["discriminator"])
    assert d_before[1], "the D step made the discriminator's Adam state"
    g_step(tuple(torch.from_numpy(a) for a in g_batch))
    assert _same(_snapshot(tb.modules.discriminator, opts["discriminator"]),
                 d_before)
    assert not _same(_snapshot(tb.modules.generator, opts["generator"]),
                     g_before)


def test_generator_step_leaves_the_discriminator_batchnorm_buffers():
    """The discriminator runs in training mode in the G step (batch
    statistics, as JAX's ``train=True``) and its running statistics stay
    as they were; a plain call in training mode would move them."""
    _, tb = _gan_setup()
    _, g_batch = _gan_batches()
    _, g_step = tb.make_gan_steps(tb.d_loss_fn, tb.g_loss_fn,
                                  "discriminator", "generator")
    bn = tb.modules.discriminator.bn_in
    before = [bn.running_mean.clone(), bn.running_var.clone()]
    g_step(tuple(torch.from_numpy(a) for a in g_batch))
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    x = torch.from_numpy(_rand(2, 10, N_FREQ, 2, seed=15, positive=True))
    frozen = forward_with_frozen_buffers(tb.modules.discriminator, x)
    assert torch.equal(bn.running_mean, before[0])
    plain = tb.modules.discriminator(x)
    assert torch.equal(frozen, plain)
    assert not torch.equal(bn.running_mean, before[0])


def test_both_optimizers_are_checkpointed_and_recovered(tmp_path):
    """Each group's optimizer is a recoverable of its own
    (``optimizer_generator``, ``optimizer_discriminator``): a new Brain
    recovers both states, step counts included."""
    _, tb = _gan_setup()
    d_batch, g_batch = _gan_batches()
    ckpt = Checkpointer(str(tmp_path))
    tb.checkpointer = ckpt
    d_step, g_step = tb.make_gan_steps(tb.d_loss_fn, tb.g_loss_fn,
                                       "discriminator", "generator")
    for name, opt in tb.optimizers_dict.items():
        ckpt.add_recoverable(f"optimizer_{name}", opt)
    d_step(tuple(torch.from_numpy(a) for a in d_batch))
    g_step(tuple(torch.from_numpy(a) for a in g_batch))
    d_step(tuple(torch.from_numpy(a) for a in d_batch))
    ckpt.save_checkpoint()
    saved = {n: o.state_dict() for n, o in tb.optimizers_dict.items()}

    _, fresh = _gan_setup()
    ckpt2 = Checkpointer(str(tmp_path))
    fresh.checkpointer = ckpt2
    fresh.make_gan_steps(fresh.d_loss_fn, fresh.g_loss_fn,
                         "discriminator", "generator")
    for name, opt in fresh.optimizers_dict.items():
        ckpt2.add_recoverable(f"optimizer_{name}", opt)
    assert ckpt2.recover_if_possible()
    for name, opt in fresh.optimizers_dict.items():
        got = opt.state_dict()["state"]
        want = saved[name]["state"]
        assert got.keys() == want.keys() and got
        for k in want:
            for field, value in want[k].items():
                assert torch.equal(got[k][field], value), (name, k, field)
    assert float(saved["discriminator"]["state"][0]["step"]) == 2
    assert float(saved["generator"]["state"][0]["step"]) == 1


def test_brain_registers_each_group_optimizer(tmp_path):
    """``Brain(checkpointer=...)`` with a dict ``opt_class`` registers
    ``optimizer_<name>`` for each; a module with trainable parameters and
    no optimizer raises; ``fit``'s update steps every group."""
    ckpt = Checkpointer(str(tmp_path))
    lin = lambda: torch.nn.Linear(2, 2)  # noqa: E731
    brain = Brain(modules={"a": lin(), "b": lin()},
                  opt_class={"a": lambda p: torch.optim.SGD(p, lr=0.1),
                             "b": lambda p: torch.optim.SGD(p, lr=0.1)},
                  run_opts={"device": "cpu"}, checkpointer=ckpt)
    brain.init_optimizers()
    assert {"optimizer_a", "optimizer_b"} <= set(ckpt.recoverables)
    before = [p.detach().clone() for p in brain.modules.parameters()]
    for p in brain.modules.parameters():
        p.grad = torch.ones_like(p)
    brain.optimizer.step()
    assert all(not torch.equal(a, p) for a, p in
               zip(before, brain.modules.parameters()))
    partial = Brain(modules={"a": lin(), "b": lin()},
                    opt_class={"a": lambda p: torch.optim.SGD(p, lr=0.1)},
                    run_opts={"device": "cpu"})
    with pytest.raises(ValueError, match=r"\['b'\]"):
        partial.init_optimizers()
