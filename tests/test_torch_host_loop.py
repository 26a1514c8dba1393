"""The training loop's host side on the port against the JAX package's
``Brain``: the finite check on the device with ``loss_sync_interval``,
checkpoint averaging, the early-stopping epoch counter, the profiler
option and the logger.

A linear model trains on 8 micro-batches of one example, accumulation 2,
clip 5, AdamW, the fourth micro-batch's input NaN (its window stretches to
the fifth): the parameters after the fit agree with JAX's to 1e-6
absolute (size about 1, float32, AdamW divides in another order) and the
epoch's mean loss to 1e-5 relative (float32 losses of size about 4 from
another matmul), for ``loss_sync_interval`` 1 and 4; the port's windowed
means agree with its per-step ones to 1e-6.
A window of NaN micro-batches leaves the parameters and AdamW's state bit
for bit as they were. Averages of checkpoints are float64 means: held
exactly."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import json
import logging

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import speechbrain_tpu as sb
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.utils import epoch_loop as jax_epoch_loop
from speechbrain_tpu.utils import logger as jax_logger
from speechbrain_tpu.utils.checkpoints import Checkpointer as JaxCheckpointer
from speechbrain_tpu.utils.checkpoints import PytreeRef
from speechbrain_tpu.utils.checkpoints import (
    average_checkpoints as jax_average_checkpoints,
)
from speechbrain_tpu_torch.core import Brain
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.dataio.sampler import DynamicBatchSampler
from speechbrain_tpu_torch.utils import logger as port_logger
from speechbrain_tpu_torch.utils.checkpoints import (
    Checkpointer,
    average_checkpoints,
)
from speechbrain_tpu_torch.utils.epoch_loop import (
    EpochCounter,
    EpochCounterWithStopper,
)

LR = 0.05
RNG = np.random.default_rng(0)
W0 = RNG.standard_normal((3, 2)).astype(np.float32)
B0 = RNG.standard_normal(2).astype(np.float32)


def _data(n=8, nan_at=(3,)):
    rng = np.random.default_rng(1)
    data = {}
    for i in range(n):
        x = rng.standard_normal((2, 3)).astype(np.float32) * 3.0
        if i in nan_at:
            x[:] = np.nan
        data[f"u{i}"] = {"x": x, "y": rng.standard_normal((2, 2))
                         .astype(np.float32), "duration": float(i % 3 + 1)}
    return data


class JaxTiny(sb.Brain):
    def compute_forward(self, params, state, batch, stage, rng):
        x, _ = batch["x"]
        return x @ params["m"]["w"] + params["m"]["b"], state

    def compute_objectives(self, predictions, batch, stage):
        y, _ = batch["y"]
        return jnp.mean((predictions - y) ** 2)

    def init_forward(self, rng, eb):
        return {"params": {"m": {"w": jnp.asarray(W0),
                                 "b": jnp.asarray(B0)}}}


class Tiny(Brain):
    def compute_forward(self, batch, stage):
        return self.modules.lin(batch["x"].data)

    def compute_objectives(self, predictions, batch, stage):
        return ((predictions - batch["y"].data) ** 2).mean()


def _linear():
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(W0.T.copy()))
        lin.bias.copy_(torch.from_numpy(B0))
    return lin


def _adamw(params):
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _run_opts(k):
    return {"loss_sync_interval": k, "grad_accumulation_factor": 2,
            "max_grad_norm": 5.0, "noprogressbar": True}


def _dataset(cls, data):
    ds = cls(data)
    ds.set_output_keys(["id", "x", "y"])
    return ds


def _jax_fit(k, data):
    brain = JaxTiny(modules={},
                    opt_class=lambda: optax.adamw(LR, weight_decay=1e-4),
                    hparams={}, run_opts=_run_opts(k))
    brain.fit(EpochCounter(1), _dataset(JaxDataset, data), None,
              train_loader_kwargs={"batch_size": 1})
    return brain


def _fit(k, data, **loader):
    brain = Tiny(modules={"lin": _linear()}, opt_class=_adamw,
                 run_opts={"device": "cpu", **_run_opts(k)})
    brain.fit(EpochCounter(1), _dataset(DynamicItemDataset, data),
              train_loader_kwargs={"batch_size": 1, **loader})
    return brain


@pytest.mark.parametrize("k", [1, 4])
def test_fit_with_a_nan_micro_batch_matches_jax(k):
    data = _data()
    j = _jax_fit(k, data)
    t = _fit(k, data)
    np.testing.assert_allclose(t.modules.lin.weight.detach().numpy().T,
                               np.asarray(j.params["m"]["w"]), atol=1e-6)
    np.testing.assert_allclose(t.modules.lin.bias.detach().numpy(),
                               np.asarray(j.params["m"]["b"]), atol=1e-6)
    assert t.train_loss == pytest.approx(j.train_loss, rel=1e-5)
    assert (t.optimizer_step, t.nonfinite_count) == (
        j.optimizer_step, j.nonfinite_count) == (4, 1)
    # AdamW stepped three times: the NaN micro-batch stretched a window
    assert float(t.optimizer.state[t.modules.lin.weight]["step"]) == 3
    # one host read a micro-batch (the last at the epoch's end), or one
    # every k
    assert t.host_syncs == (8 if k == 1 else 2)


def test_windowed_reads_average_the_per_step_losses():
    data = _data(nan_at=())
    means = {k: _fit(k, data).train_loss for k in (1, 3, 4)}
    assert means[3] == pytest.approx(means[1], rel=1e-6)
    assert means[4] == pytest.approx(means[1], rel=1e-6)


def test_a_nan_window_changes_nothing_bit_for_bit():
    data = _data(n=4, nan_at=())
    brain = _fit(1, data)
    nan = _data(n=2, nan_at=(0, 1))
    from speechbrain_tpu_torch.dataio.batch import PaddedBatch

    before = {n: p.detach().clone()
              for n, p in brain.modules.named_parameters()}
    opt_before = {
        (id(p), key): v.clone()
        for p, st in brain.optimizer.state.items() for key, v in st.items()
    }
    window, count = [w.clone() for w in brain._window], \
        brain._window_count.clone()
    for ex in nan.values():
        brain.fit_batch(PaddedBatch([{"x": ex["x"], "y": ex["y"]}]))
    for n, p in brain.modules.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    for p, st in brain.optimizer.state.items():
        for key, v in st.items():
            assert torch.equal(v, opt_before[(id(p), key)]), key
    assert all(torch.equal(a, b) for a, b in zip(brain._window, window))
    assert torch.equal(brain._window_count, count)


class NaNGradient(Tiny):
    """Micro-batch 5's loss is finite and its gradient NaN
    (``sqrt(0 * loss)`` adds 0 to the loss and 0 * inf to its
    gradient)."""

    def compute_objectives(self, predictions, batch, stage):
        loss = super().compute_objectives(predictions, batch, stage)
        if self._micro_step == 5:
            loss = loss + torch.sqrt(0.0 * loss)
        return loss


def test_skip_nonfinite_grads_catches_a_finite_loss_with_nan_gradient():
    data = _data(nan_at=())
    brain = NaNGradient(modules={"lin": _linear()}, opt_class=_adamw,
                        run_opts={"device": "cpu",
                                  "skip_nonfinite_grads": True,
                                  **_run_opts(4)})
    brain.fit(EpochCounter(1), _dataset(DynamicItemDataset, data),
              train_loader_kwargs={"batch_size": 1})
    assert brain.nonfinite_count == 1
    assert float(brain.optimizer.state[brain.modules.lin.weight]["step"]) \
        == 3
    assert all(torch.isfinite(p).all() for p in brain.modules.parameters())


def test_fit_through_threads_and_dynamic_batches_matches_plain():
    data = _data(nan_at=())
    plain = _fit(1, data)
    tds = _dataset(DynamicItemDataset, data)
    dyn = _fit(1, data, num_workers=3,
               batch_sampler=DynamicBatchSampler(tds, 1.0,
                                                 bucket_boundaries=[1.0]))
    # one example a batch in both, in dataset order vs drawn order
    assert dyn.optimizer_step == plain.optimizer_step == 4
    looped = _fit(1, data, looped_nominal_epoch=3)
    assert looped.optimizer_step == 1  # 3 micro-batches, accumulation 2


def _ckpt_state(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 2)).astype(np.float32),
            "count": np.asarray(seed, np.int64)}


def test_average_checkpoints_matches_jax(tmp_path):
    jref = PytreeRef()
    jck = JaxCheckpointer(tmp_path / "jax", {"params": jref})
    module = torch.nn.Module()
    module.register_parameter("w", torch.nn.Parameter(torch.zeros(3, 2)))
    module.register_buffer("count", torch.zeros((), dtype=torch.int64))
    tck = Checkpointer(tmp_path / "torch", {"modules": module})
    for i, seed in enumerate((1, 2, 3)):
        state = _ckpt_state(seed)
        jref.tree = {"w": jnp.asarray(state["w"]),
                     "count": jnp.asarray(state["count"])}
        jck.save_checkpoint(meta={"loss": float(i)})
        module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                for k, v in state.items()})
        tck.save_checkpoint(meta={"loss": float(i)})
    jbest = jck.find_checkpoints(min_key="loss", max_num_checkpoints=2)
    tbest = tck.find_checkpoints(min_key="loss", max_num_checkpoints=2)
    javg = jax_average_checkpoints(jbest, "params")
    tavg = average_checkpoints(tbest, "modules")
    np.testing.assert_array_equal(tavg["w"].numpy(), np.asarray(javg["w"]))
    assert int(tavg["count"]) == int(np.asarray(javg["count"])) == 1

    brain = Brain(modules={"m": module}, run_opts={"device": "cpu"},
                  checkpointer=Checkpointer(tmp_path / "brain"))
    for seed in (4, 5, 6):
        module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                for k, v in _ckpt_state(seed).items()})
        brain.checkpointer.save_checkpoint()
    ckpts = brain.checkpointer.find_checkpoints(max_num_checkpoints=2)
    assert brain.load_averaged_checkpoints(2) == 2
    expected = sum(torch.load(c.paramfiles["modules"])["m.w"].double()
                   for c in ckpts) / 2
    assert torch.equal(module.w.detach(), expected.float())
    assert int(module.count) == 6  # the newest's


def test_epoch_counter_with_stopper_matches_jax(tmp_path):
    metrics = [5.0, 4.0, 4.5, 4.2, 3.0, 3.5, 3.6, 3.7, 1.0, 0.5]
    for direction, sign in (("min", 1.0), ("max", -1.0)):
        runs = []
        for cls in (jax_epoch_loop.EpochCounterWithStopper,
                    EpochCounterWithStopper):
            counter = cls(10, limit_to_stop=2, limit_warmup=1,
                          direction=direction)
            seen = []
            for epoch in counter:
                seen.append(epoch)
                counter.update_metric(sign * metrics[epoch - 1])
            runs.append((seen, counter.best_limit, counter.patience_counter))
        assert runs[0] == runs[1]
        assert runs[1][0] == [1, 2, 3, 4]
    counter._save(tmp_path / "c.ckpt")
    assert (tmp_path / "c.ckpt").read_text() == "4"
    fresh = EpochCounterWithStopper(10, 2, 1, "min")
    fresh._recover(tmp_path / "c.ckpt", end_of_epoch=False)
    assert next(fresh) == 4
    with pytest.raises(ValueError):
        EpochCounterWithStopper(3, 1, 0, "sideways")


def test_profile_training_writes_a_chrome_trace(tmp_path):
    brain = Tiny(modules={"lin": _linear()}, opt_class=_adamw,
                 hparams={"output_folder": str(tmp_path)},
                 run_opts={"device": "cpu", "profile_training": True,
                           "profile_warmup": 2, "profile_steps": 3,
                           **_run_opts(1)})
    brain.fit(EpochCounter(1), _dataset(DynamicItemDataset,
                                        _data(nan_at=())),
              train_loader_kwargs={"batch_size": 1})
    traces = list((tmp_path / "profiler_logs").glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert any("addmm" in str(n) or "linear" in str(n) for n in names)


def test_logger_matches_jax(caplog):
    for x in (0, 1, 999, 1300000, 0.00042, -2.5e9, 1e30):
        assert port_logger.format_order_of_magnitude(x) == \
            jax_logger.format_order_of_magnitude(x)
    log = port_logger.get_logger("port_logger_test")
    with caplog.at_level(logging.WARNING):
        log.warning_once("only once %d", 1)
        log.warning_once("only once %d", 1)
    assert caplog.text.count("only once 1") == 1
    env = port_logger.get_environment_description()
    assert f"torch: {torch.__version__}" in env and "jax" not in env
