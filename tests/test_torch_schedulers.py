"""Noam's learning rates and the optimizer update of the port against the
JAX package on the same numpy gradients.

The JAX side is the update ``speechbrain_tpu/core.py`` makes: each
micro-batch's gradients clipped to global norm 5 (``+1e-6``), fed to
``optax.MultiSteps(optax.inject_hyperparams(optax.adamw))`` (k = 2: the
mean of two clipped gradients, then AdamW with weight decay 1e-4), the
learning rate written by ``update_learning_rate`` after every applied
update, and a micro-batch whose gradient norm is not finite leaving
everything as it was (``skip_nonfinite_grads``). The port's side is
``Brain._accumulate`` with ``torch.optim.AdamW`` and the port's
``update_learning_rate``.

Tolerance: 1e-6 absolute on parameters of size about 1 after three
updates of size about 1e-3 (float32; the two AdamWs divide in another
order). Noam's rates are Python floats on both sides: equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from speechbrain_tpu.core import optax_global_norm
from speechbrain_tpu.utils.optimizers import vector_weight_decay_mask
from speechbrain_tpu.nnet.schedulers import (
    NoamScheduler as JaxNoam,
    update_learning_rate as jax_update_lr,
)
from speechbrain_tpu_torch.core import Brain
from speechbrain_tpu_torch.nnet.schedulers import (
    NoamScheduler,
    update_learning_rate,
)
from speechbrain_tpu_torch.utils.optimizers import rm_vector_weight_decay

SHAPES = {"w": (3, 4), "b": (4,), "v": (2, 3, 2)}
MAX_NORM = 5.0


@pytest.mark.parametrize("warmup,model_size", [(10, None), (4, 512)])
def test_noam_rates_match(warmup, model_size):
    j = JaxNoam(lr_initial=8e-4, n_warmup_steps=warmup,
                model_size=model_size)
    t = NoamScheduler(lr_initial=8e-4, n_warmup_steps=warmup,
                      model_size=model_size)
    for step in range(1, 40):
        assert t(None) == j(None)
        assert t(step) == j(step)
    assert (t.current_lr, t.n_steps) == (j.current_lr, j.n_steps)


def test_noam_checkpoint_round_trip(tmp_path):
    t = NoamScheduler(lr_initial=1.0, n_warmup_steps=3)
    for _ in range(5):
        t(None)
    t._save(tmp_path / "noam.ckpt")
    fresh = NoamScheduler(lr_initial=1.0, n_warmup_steps=3)
    fresh._load(tmp_path / "noam.ckpt")
    assert (fresh.current_lr, fresh.n_steps) == (t.current_lr, t.n_steps)
    assert fresh(None) == t(None)


def test_update_learning_rate_groups():
    a, b = torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(
        torch.zeros(2))
    opt = torch.optim.SGD([{"params": [a], "name": "enc"},
                           {"params": [b], "name": "head"}], lr=1.0)
    update_learning_rate(opt, 0.5, group="head")
    assert [g["lr"] for g in opt.param_groups] == [1.0, 0.5]
    update_learning_rate(opt, 0.125)
    assert [g["lr"] for g in opt.param_groups] == [0.125, 0.125]
    with pytest.raises(ValueError):
        update_learning_rate(opt, 1.0, group="missing")


def test_rm_vector_weight_decay_groups():
    lin = torch.nn.Linear(3, 4)
    groups = rm_vector_weight_decay(lin)
    assert groups[0]["weight_decay"] == 0.0
    assert [p.shape for p in groups[0]["params"]] == [torch.Size([4])]
    assert [p.shape for p in groups[1]["params"]] == [torch.Size([4, 3])]


def test_rm_vector_weight_decay_matches_the_jax_mask():
    """A 0-d, a 1-D and a 2-D parameter: each is decayed by the port
    exactly where JAX's mask decays it (only the 2-D one)."""
    shapes = {"scalar": (), "vector": (4,), "matrix": (4, 3)}
    module = _Params({k: np.zeros(s, np.float32) for k, s in shapes.items()})
    groups = rm_vector_weight_decay(module)
    names = {id(p): n for n, p in module.named_parameters()}
    decayed = {names[id(p)]: g.get("weight_decay") != 0.0
               for g in groups for p in g["params"]}
    mask = vector_weight_decay_mask(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    assert decayed == {k: bool(v) for k, v in mask.items()}
    assert decayed == {"scalar": False, "vector": False, "matrix": True}


class _Params(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for name, value in init.items():
            self.register_parameter(
                name, torch.nn.Parameter(torch.from_numpy(value.copy()))
            )


def _jax_micro_step(opt, params, opt_state, grads, skip_nonfinite):
    """The tail of ``speechbrain_tpu/core.py``'s train step (:631-654)."""
    finite = jnp.asarray(True)
    if skip_nonfinite:
        finite = jnp.isfinite(optax_global_norm(grads))
    grads = jax.tree_util.tree_map(
        lambda g: jnp.where(finite, g, jnp.zeros_like(g)), grads)
    gnorm = optax_global_norm(grads)
    scale = jnp.minimum(1.0, MAX_NORM / (gnorm + 1e-6))
    grads = jax.tree_util.tree_map(lambda g: g * scale, grads)
    updates, new_state = opt.update(grads, opt_state, params)
    new_params = optax.apply_updates(params, updates)
    new_params = jax.tree_util.tree_map(
        lambda n, o: jnp.where(finite, n, o), new_params, params)
    new_state = jax.tree_util.tree_map(
        lambda n, o: jnp.where(finite, n, o), new_state, opt_state)
    return new_params, new_state


def _accumulate(brain, params, grads):
    """One micro-batch's gradients, with a finite loss, through the
    Brain's update as ``fit_batch`` hands them on after its backward;
    returns whether the micro-batch counted as finite."""
    for p, g in zip(params, grads):
        p.grad = g
    return bool(brain._accumulate(params, torch.tensor(True)))


def test_clip_accumulate_adamw_matches_optax_multisteps():
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    # micro-batch gradients: norms about 0.5 (no clip) and about 50
    # (clipped to 5); the fourth is not finite and must change nothing
    scales = [0.2, 20.0, 0.2, None, 20.0, 20.0, 0.2]
    grads = []
    for s in scales:
        g = {k: rng.standard_normal(v).astype(np.float32) * (s or 1.0)
             for k, v in SHAPES.items()}
        if s is None:
            g["b"][1] = np.inf
        grads.append(g)

    opt = optax.MultiSteps(
        optax.inject_hyperparams(optax.adamw)(learning_rate=8e-4),
        every_k_schedule=2,
    )
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = opt.init(j_params)
    j_noam = JaxNoam(lr_initial=8e-4, n_warmup_steps=3)

    module = _Params(init)
    brain = Brain(
        modules={"p": module},
        opt_class=lambda params: torch.optim.AdamW(
            params, lr=8e-4, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4),
        run_opts={"device": "cpu", "grad_accumulation_factor": 2,
                  "max_grad_norm": MAX_NORM, "skip_nonfinite_grads": True},
    )
    brain.init_optimizers()
    t_noam = NoamScheduler(lr_initial=8e-4, n_warmup_steps=3)
    names = [n for n, _ in module.named_parameters()]
    params = list(module.parameters())

    applied = 0
    for g in grads:
        j_params, j_state = _jax_micro_step(
            opt, j_params, j_state, {k: jnp.asarray(v) for k, v in g.items()},
            skip_nonfinite=True)
        before = brain._window_count
        ok = _accumulate(
            brain, params, [torch.from_numpy(g[n].copy()) for n in names])
        assert ok == bool(np.all([np.isfinite(v).all() for v in g.values()]))
        stepped = ok and before == 1
        if stepped:
            applied += 1
            _, lr = j_noam(None)
            j_state = jax_update_lr(j_state, lr)
            update_learning_rate(brain.optimizer, t_noam(None)[1])
        for n, p in zip(names, params):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(j_params[n]), atol=1e-6)
    assert applied == 3
    assert brain._window_count == 0


def test_accumulation_without_clip_is_the_mean():
    """max_grad_norm 0: two micro-batches step SGD on their mean."""
    module = _Params({"w": np.zeros(3, np.float32)})
    brain = Brain(modules={"p": module},
                  opt_class=lambda params: torch.optim.SGD(params, lr=1.0),
                  run_opts={"device": "cpu", "grad_accumulation_factor": 2,
                            "max_grad_norm": 0.0})
    brain.init_optimizers()
    params = list(module.parameters())
    _accumulate(brain, params, [torch.tensor([1.0, 2.0, 30.0])])
    assert torch.equal(params[0].detach(), torch.zeros(3))
    _accumulate(brain, params, [torch.tensor([3.0, 4.0, 50.0])])
    assert torch.allclose(params[0].detach(), -torch.tensor([2.0, 3.0, 40.0]))
