"""The Brain training engine (port of ``speechbrain_tpu/core.py``:
``Stage``, ``RunOptions``, ``parse_arguments``,
``create_experiment_directory``, ``Brain``).

In PyTorch's idiom: ``modules`` is an ``nn.ModuleDict`` on one device
(``run_opts["device"]``, ``"cuda"`` by default); ``opt_class`` is a
``params -> torch.optim.Optimizer`` factory; subclasses override
``compute_forward(batch, stage)`` and ``compute_objectives(predictions,
batch, stage)``. The epoch loop, its hooks, the loss reporting and the
checkpoint cadence are the JAX package's, and so is the update, decided
on the device as the JAX train step decides it:

* the backward always runs; a micro-batch is *finite* where its loss is
  (with ``skip_nonfinite_grads``, and its gradients' global norm), a
  flag that stays on the device. A micro-batch that is not contributes
  zero gradients and leaves the parameters, the optimizer's state (its
  step count too) and the accumulation window exactly as they were, as
  the JAX step keeps the old ``opt_state`` of ``optax.MultiSteps``: a
  window with such a micro-batch in it stretches by one;
* each micro-batch's gradients are clipped to global norm
  ``max_grad_norm`` (``scale = min(1, max_norm / (norm + 1e-6))``), and
  with ``grad_accumulation_factor`` k the optimizer steps on the **mean**
  of k clipped gradients, as ``optax.MultiSteps`` after the JAX step's
  clip;
* since the host does not know where a window ends, the optimizer steps
  on every micro-batch and a device flag keeps or undoes the step
  (:class:`_MaskedUpdate`);
* with ``loss_sync_interval`` 1, ``fit_batch`` returns the previous
  micro-batch's loss (one host read a micro-batch, a step behind the
  device); with N > 1 the (sum, count, non-finite) of the losses build
  up on the device and the host reads them once every N micro-batches,
  returning ``(mean, count)``. The epoch's tail is drained at its end,
  so ``avg_train_loss`` averages the same losses;
* a stage in which no batch's loss is finite (one or more batches, all
  NaN or infinite) reports NaN to ``on_stage_end``, not the 0.0 that the
  running mean starts from, so that a diverged epoch can never rank as
  the best checkpoint (the JAX package reports 0.0);
* ``precision="bf16"`` runs ``compute_forward`` under ``torch.autocast``
  with bfloat16, parameters in float32 (the JAX package instead casts
  every float input, the waveform too, to bfloat16);
* ``opt_class`` may be a dict ``{module name: factory}``: one optimizer a
  group of modules, each registered with the checkpointer as
  ``optimizer_<name>``; ``make_gan_steps`` returns the alternating
  discriminator and generator updates of a GAN, each stepping its own
  group's optimizer alone (the JAX package runs one optimizer over both
  groups and feeds the other group zero gradients, which Adam's momentum
  and shared step count turn into updates: ROADMAP C50).

Not ported: meshes and several hosts.
"""

import argparse
import collections
import inspect
import logging
import math
import os
import re
import shutil
import time
from dataclasses import dataclass
from enum import Enum, auto
from types import SimpleNamespace

import numpy as np
import torch

from speechbrain_tpu_torch.dataio.dataloader import (
    LoopedLoader,
    SaveableDataLoader,
    make_dataloader,
)
from speechbrain_tpu_torch.utils.autocast import autocast
from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)
from speechbrain_tpu_torch.utils.logger import get_environment_description
from speechbrain_tpu_torch.utils.profiling import prepare_profiler

logger = logging.getLogger(__name__)

_LOADERS = (SaveableDataLoader, LoopedLoader)

INTRA_EPOCH_CKPT_FLAG = "brain_intra_epoch_ckpt"


class Stage(Enum):
    """Current phase of an experiment: TRAIN, VALID or TEST."""

    TRAIN = auto()
    VALID = auto()
    TEST = auto()


@dataclass
class RunOptions:
    """Runtime controls (the JAX package's, less its mesh and jit
    fields)."""

    debug: bool = False
    debug_batches: int = 2
    debug_epochs: int = 2
    device: str = "cuda"
    precision: str = "fp32"  # "fp32" | "bf16" | "fp16"
    eval_precision: str = "fp32"  # for VALID and TEST
    max_grad_norm: float = 5.0
    skip_nonfinite_grads: bool = False  # also skip on a nonfinite norm
    grad_accumulation_factor: int = 1
    optimizer_step_limit: int = None  # stop after N optimizer updates
    nonfinite_patience: int = 3
    loss_sync_interval: int = 1  # read the train loss every N micro-batches
    ckpt_interval_minutes: float = 0.0
    ckpt_interval_steps: int = 0
    noprogressbar: bool = False
    train_log_interval: int = 100  # log the running train loss every N
    profile_training: bool = False  # torch.profiler over some batches
    profile_warmup: int = 5
    profile_steps: int = 10
    seed: int = 563375142

    @classmethod
    def from_dict(cls, d):
        valid = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in valid})


def parse_arguments(arg_list=None):
    """Parse ``train.py hparams.yaml --name=value ...`` command lines.

    Returns ``(hparams_file, run_opts, overrides)``: each ``--name=value``
    (or ``--name value``; a bare ``--name`` is ``True``) goes to
    ``run_opts`` where ``name`` is a field of :class:`RunOptions`, else to
    ``overrides``, its value parsed by :func:`_parse_scalar`.

    Example
    -------
    >>> parse_arguments(["h.yaml", "--debug", "--lr=0.5", "--device=cpu"])
    ('h.yaml', {'debug': True, 'device': 'cpu'}, {'lr': 0.5})
    """
    parser = argparse.ArgumentParser(description="Run an experiment")
    parser.add_argument("param_file", type=str, help="hparams yaml file")
    known, unknown = parser.parse_known_args(arg_list)
    run_opt_fields = set(RunOptions.__dataclass_fields__)
    run_opts, overrides = {}, {}
    i = 0
    while i < len(unknown):
        arg = unknown[i]
        if not arg.startswith("--"):
            raise ValueError(f"Cannot parse argument {arg}")
        if "=" in arg:
            key, value = arg[2:].split("=", 1)
            i += 1
        else:
            key = arg[2:]
            if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
                value = unknown[i + 1]
                i += 2
            else:
                value = "True"
                i += 1
        parsed = _parse_scalar(value)
        if key in run_opt_fields:
            run_opts[key] = parsed
        else:
            overrides[key] = parsed
    return known.param_file, run_opts, overrides


# YAML 1.1's plain scalars as PyYAML resolves them (its implicit
# resolvers, in its order), so that a value means on the command line
# what it means in a hyperparameter file
_YAML_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                        |true|True|TRUE|false|False|FALSE
                        |on|On|ON|off|Off|OFF)$""", re.X)
_YAML_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                         |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                         |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                         |[-+]?\.(?:inf|Inf|INF)
                         |\.(?:nan|NaN|NAN))$""", re.X)
_YAML_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                       |[-+]?0[0-7_]+
                       |[-+]?(?:0|[1-9][0-9_]*)
                       |[-+]?0x[0-9a-fA-F_]+
                       |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_YAML_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _sexagesimal(value, cast):
    total, base = 0, 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _parse_scalar(value):
    """A command-line value as ``yaml.safe_load`` reads a plain scalar,
    without PyYAML (the card's machine has none): null (``~``, ``null``,
    empty), booleans (``true``/``yes``/``on`` and their negations, in
    lower, capitalised or upper case), integers (decimal, ``0b``, ``0x``,
    a leading 0 for octal, ``_`` separators, ``1:30`` base 60) and floats
    (a dot is required: ``8e-4`` stays a string, as in YAML 1.1; ``.inf``,
    ``.nan``). Anything else, collections, quoted strings, comments and
    dates included, stays a string, stripped of surrounding blanks."""
    text = value.strip()
    if _YAML_NULL.match(text):
        return None
    if _YAML_BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _YAML_FLOAT.match(text) or _YAML_INT.match(text):
        is_float = _YAML_FLOAT.match(text) is not None
        body = text.replace("_", "")
        sign = -1 if body[0] == "-" else 1
        if body[0] in "+-":
            body = body[1:]
        if is_float:
            body = body.lower()
            if body == ".inf":
                return sign * math.inf
            if body == ".nan":
                return math.nan
            if ":" in body:
                return sign * _sexagesimal(body, float)
            return sign * float(body)
        if body == "0":
            return 0
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body[0] == "0":
            return sign * int(body, 8)
        if ":" in body:
            return sign * _sexagesimal(body, int)
        return sign * int(body)
    return text


def create_experiment_directory(experiment_directory,
                                hyperparams_to_save=None, overrides={}):
    """Create the output directory, write the hyperparameter file into it
    with the overrides applied (``utils.hyperyaml.resolve_yaml``, which
    needs PyYAML where there are overrides), copy the calling script,
    describe the environment in ``env.log`` and log to ``log.txt``."""
    os.makedirs(experiment_directory, exist_ok=True)
    if hyperparams_to_save is not None:
        from speechbrain_tpu_torch.utils.hyperyaml import resolve_yaml

        with open(hyperparams_to_save, encoding="utf-8") as f:
            resolved = resolve_yaml(f.read(), overrides)
        with open(os.path.join(experiment_directory, "hyperparams.yaml"),
                  "w", encoding="utf-8") as w:
            w.write(resolved)
    module = inspect.getmodule(inspect.currentframe().f_back)
    callingfile = getattr(module, "__file__", None)
    if callingfile and os.path.isfile(callingfile):
        shutil.copy(callingfile, os.path.join(
            experiment_directory, os.path.basename(callingfile)))
    handler = logging.FileHandler(
        os.path.join(experiment_directory, "log.txt"), encoding="utf-8"
    )
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    ))
    logging.getLogger().addHandler(handler)
    with open(os.path.join(experiment_directory, "env.log"), "w",
              encoding="utf-8") as f:
        f.write(get_environment_description())


@register_checkpoint_hooks
class Brain:
    """Generic training engine: override ``compute_forward`` and
    ``compute_objectives``.

    Arguments
    ---------
    modules : dict[str, nn.Module]
        The model's parts, moved into ``self.modules``, an
        ``nn.ModuleDict`` on ``run_opts["device"]``.
    opt_class : callable or dict, optional
        ``params -> torch.optim.Optimizer``, called with
        ``self.modules.parameters()`` at the start of ``fit``; or a dict
        ``{module name: factory}``, one optimizer a module's parameters
        (``self.optimizers_dict``), which ``fit`` steps together and
        ``make_gan_steps`` one at a time.
    hparams : dict, optional
        Exposed as ``self.hparams.<key>``; a key named like a run option
        sets it where ``run_opts`` does not.
    run_opts : dict | RunOptions, optional
    checkpointer : Checkpointer, optional
        Gets the Brain's counters, the modules, the optimizer and the
        train loader as recoverables.

    Hooks, called in the JAX package's order: ``on_fit_start``,
    ``on_stage_start``/``on_stage_end``, ``on_fit_batch_start``/
    ``on_fit_batch_end(batch, outputs, loss, should_step)``,
    ``on_evaluate_start``.
    """

    def __init__(self, modules=None, opt_class=None, hparams=None,
                 run_opts=None, checkpointer=None):
        if isinstance(run_opts, RunOptions):
            self.run_opts = run_opts
        else:
            self.run_opts = RunOptions.from_dict(run_opts or {})
        if isinstance(hparams, dict) and isinstance(run_opts, dict):
            for opt in RunOptions.__dataclass_fields__:
                if opt in hparams and opt not in run_opts:
                    setattr(self.run_opts, opt, hparams[opt])
        self.device = torch.device(self.run_opts.device)
        self.modules = torch.nn.ModuleDict(modules or {}).to(self.device)
        self.opt_class = opt_class
        self.hparams = SimpleNamespace(**(hparams or {}))
        self.checkpointer = checkpointer
        self.optimizer = None
        self.optimizers_dict = None
        self.step = 0  # batch within the current stage
        self.optimizer_step = 0  # windows the host has counted
        self._micro_step = 0  # micro-batches seen
        self._pending_loss = None  # the loss reported one call late
        self._loss_accum = None  # (sum, count, non-finite) on the device
        self._grads = None  # _FlatGrads: the parameters' .grad
        self._window = None  # running mean of the window's gradients
        self._window_count = None  # finite micro-batches in it (device)
        self._masked_update = _MaskedUpdate()
        self.host_syncs = 0  # host reads of the train loss
        self.avg_train_loss = 0.0
        self.nonfinite_count = 0
        self._finite_losses = 0  # finite losses read in this TRAIN stage
        self.last_ckpt_time = time.time()
        # dropout draws from torch's generator of the device
        if self.device.type == "cuda":
            torch.cuda.manual_seed(self.run_opts.seed)
        else:
            torch.default_generator.manual_seed(self.run_opts.seed)
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable("brain", self)
            self.checkpointer.add_recoverable("modules", self.modules)

    # -- override points -------------------------------------------------
    def compute_forward(self, batch, stage):
        """Forward pass: return the predictions."""
        raise NotImplementedError

    def compute_objectives(self, predictions, batch, stage):
        """Return a scalar loss, or ``(loss, metrics dict)``."""
        raise NotImplementedError

    def on_stage_start(self, stage, epoch=None):
        pass

    def on_stage_end(self, stage, stage_loss, epoch=None):
        pass

    def on_fit_start(self):
        """Build the optimizer and recover the newest checkpoint, if
        any."""
        self.init_optimizers()
        if self.checkpointer is not None:
            self.checkpointer.recover_if_possible()

    def on_fit_batch_start(self, batch):
        pass

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        pass

    def on_evaluate_start(self, max_key=None, min_key=None):
        if self.checkpointer is not None:
            self.checkpointer.recover_if_possible(max_key=max_key,
                                                  min_key=min_key)

    def init_optimizers(self):
        """Build the optimizer from ``opt_class`` (once) and register it
        with the checkpointer, as ``optimizer``, or with a dict
        ``opt_class`` one optimizer a group as ``optimizer_<name>``. On a
        CUDA device, an optimizer with a ``capturable`` option (Adam,
        AdamW) gets it, so that its step count lives on the device, where
        the update is kept or undone without a host read."""
        if self.opt_class is None or self.optimizer is not None:
            return
        if isinstance(self.opt_class, dict):
            trained = {name for name, module in self.modules.items()
                       if any(p.requires_grad for p in module.parameters())}
            missing = sorted(trained - set(self.opt_class))
            if missing:
                raise ValueError(f"opt_class names no optimizer for the "
                                 f"modules {missing}")
            self.optimizers_dict = {
                name: self._new_optimizer(factory,
                                          self.modules[name].parameters(),
                                          f"optimizer_{name}")
                for name, factory in self.opt_class.items()}
            self.optimizer = _GroupOptimizers(self.optimizers_dict)
        else:
            self.optimizer = self._new_optimizer(
                self.opt_class, self.modules.parameters(), "optimizer")

    def _new_optimizer(self, factory, params, name):
        optimizer = factory(params)
        if self.device.type == "cuda":
            for group in optimizer.param_groups:
                if "capturable" in group:
                    group["capturable"] = True
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable(name, optimizer)
        return optimizer

    def make_gan_steps(self, d_loss_fn, g_loss_fn, d_key, g_key):
        """The two alternating updates of GAN training (upstream
        SpeechBrain's ``d_optimizer``/``g_optimizer`` pattern):
        ``d_step(batch, generator=None)`` and ``g_step(...)``, each
        returning its loss (detached, on the device).

        ``d_loss_fn``/``g_loss_fn`` take ``(batch, generator)``, the
        ``torch.Generator`` of the step's random draws (or None), and
        return a scalar loss. Each step differentiates its loss with
        respect to its own module group (``d_key`` or ``g_key``) alone and
        steps that group's optimizer alone, with its own state and step
        count: the other group's parameters and optimizer state stay as
        they were, bit for bit. A loss function that runs the other
        group's BatchNorm in training mode leaves its running statistics
        alone by calling it through :func:`forward_with_frozen_buffers`.

        ``opt_class`` is a dict with a factory for each of the two
        groups."""
        self.init_optimizers()
        groups = self.optimizers_dict or {}
        if d_key not in groups or g_key not in groups:
            raise ValueError(
                f"make_gan_steps needs one optimizer for each of "
                f"{d_key!r} and {g_key!r}; opt_class gave "
                f"{sorted(groups)}")

        def make_step(loss_fn, key):
            optimizer = groups[key]
            params = [p for p in self.modules[key].parameters()
                      if p.requires_grad]

            def step(batch, generator=None):
                with autocast(self.run_opts.precision, self.device):
                    loss = loss_fn(batch, generator)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                for p, g in zip(params, grads):
                    p.grad = None if g is None else g.to(p.dtype)
                optimizer.step()
                for p in params:
                    p.grad = None
                return loss.detach()

            return step

        return make_step(d_loss_fn, d_key), make_step(g_loss_fn, g_key)

    def load_averaged_checkpoints(self, n, max_key=None, min_key=None):
        """Load into the modules the elementwise mean of the modules'
        state in the ``n`` best checkpoints by ``max_key``/``min_key``
        (the newest without a key): float entries averaged in float64,
        integer ones taken from the first. Returns how many were
        averaged."""
        from speechbrain_tpu_torch.utils.checkpoints import (
            average_checkpoints,
        )

        ckpts = self.checkpointer.find_checkpoints(
            max_key=max_key, min_key=min_key, max_num_checkpoints=n
        )
        if not ckpts:
            raise RuntimeError("No checkpoints found to average")
        self.modules.load_state_dict(average_checkpoints(ckpts, "modules"))
        return len(ckpts)

    # -- checkpoint of the Brain's own state ------------------------------
    @mark_as_saver
    def _save(self, path):
        torch.save({
            "step": self.step,
            "optimizer_step": self.optimizer_step,
            "micro_step": self._micro_step,
            "avg_train_loss": self.avg_train_loss,
            "window_count": self._window_count,
            "window": self._window,
        }, path)

    @mark_as_loader
    def _recover(self, path, end_of_epoch):
        saved = torch.load(path, map_location=self.device, weights_only=True)
        self.step = saved["step"]
        self.optimizer_step = saved["optimizer_step"]
        self._micro_step = saved["micro_step"]
        self.avg_train_loss = saved["avg_train_loss"]
        self._window_count = saved["window_count"]
        self._window = saved["window"]
        if end_of_epoch:
            self.step = 0

    # -- one batch --------------------------------------------------------
    def _prepare_batch(self, batch):
        """The batch on the device. The upload does not wait for the
        device (``non_blocking``: from pinned memory, as the Brain's
        loaders pin their batches on a CUDA device, it is a queued DMA)."""
        if hasattr(batch, "to"):
            return batch.to(self.device, non_blocking=True)
        return batch

    def _objectives(self, predictions, batch, stage):
        objectives = self.compute_objectives(predictions, batch, stage)
        if isinstance(objectives, tuple):
            return objectives
        return objectives, {}

    def _params_with_grads(self):
        return [p for p in self.modules.parameters() if p.requires_grad]

    def fit_batch(self, batch):
        """One training micro-batch: forward, backward, this micro-batch's
        clip, accumulation, and the optimizer's update where a window is
        full, with no host read before the update is issued.

        Returns, with ``loss_sync_interval`` 1, the PREVIOUS call's loss
        as a Python float (None on the first call of an epoch), as the
        JAX package does; with N > 1, ``(mean, count)`` of the finite
        losses of the last N micro-batches every N-th call, else None.
        """
        batch = self._prepare_batch(batch)
        with autocast(self.run_opts.precision, self.device):
            predictions = self.compute_forward(batch, Stage.TRAIN)
        loss, metrics = self._objectives(predictions, batch, Stage.TRAIN)
        params = self._params_with_grads()
        self._flat_grads(params).zero_()
        loss.backward()
        loss = loss.detach()
        finite = self._accumulate(params, torch.isfinite(loss))
        gaf = max(1, self.run_opts.grad_accumulation_factor)
        self._micro_step += 1
        should_step = self._micro_step % gaf == 0
        if should_step:
            self.optimizer_step += 1
        self.on_fit_batch_end(batch, metrics, loss, should_step)
        k = max(1, self.run_opts.loss_sync_interval)
        if k > 1:
            ok = finite.to(torch.float32)
            step = torch.stack([torch.where(finite, loss.float(), 0.0), ok,
                                1.0 - ok])
            self._loss_accum = (step if self._loss_accum is None
                                else self._loss_accum + step)
            if self._micro_step % k == 0:
                return self._drain_loss_accum()
            return None
        pending, self._pending_loss = self._pending_loss, loss
        if pending is None:
            return None
        return self._host_loss(pending)

    def _flat_grads(self, params):
        """The parameters' gradients as a :class:`_FlatGrads` (made anew,
        holding the current ``.grad`` values, where a ``.grad`` is not
        its view)."""
        if self._grads is None or not self._grads.holds(params):
            self._grads = _FlatGrads(params)
        return self._grads

    @torch.no_grad()
    def _accumulate(self, params, finite):
        """Clip this micro-batch's gradients (the parameters' ``.grad``),
        fold them into the window's running mean, and step the optimizer
        where the window is full. ``finite`` (a 0-d device flag) becomes
        false also where ``skip_nonfinite_grads`` finds the gradient norm
        not finite; a micro-batch that is not finite changes nothing.
        Returns the flag."""
        opts = self.run_opts
        grads = self._flat_grads(params)
        if opts.skip_nonfinite_grads:
            finite = finite & torch.isfinite(grads.norm())
        grads.zero_where_not(finite)
        if opts.max_grad_norm and opts.max_grad_norm > 0:
            scale = torch.clamp(opts.max_grad_norm / (grads.norm() + 1e-6),
                                max=1.0)
            grads.mul_(scale)
        gaf = max(1, opts.grad_accumulation_factor)
        if gaf == 1:
            do_step = finite
        else:
            if self._window is None:
                self._window = [torch.zeros_like(b) for b in grads.buffers]
                self._window_count = torch.zeros((), device=self.device)
            ok = finite.to(torch.float32)
            count = self._window_count + ok
            # running mean, acc + (g - acc) / n, as optax.MultiSteps; a
            # weight of 0 leaves it as it was
            weight = ok / torch.clamp(count, min=1.0)
            for w, g in zip(self._window, grads.buffers):
                w.lerp_(g, weight)
            do_step = count >= gaf
            self._window_count = torch.where(do_step, 0.0, count)
            grads.copy_from(self._window)
        self._masked_update.step(self.optimizer, params, do_step)
        return finite
    def _host_loss(self, loss):
        """The loss as a Python float (a host read), with the nonfinite
        patience."""
        self.host_syncs += 1
        loss = float(loss)
        if not np.isfinite(loss):
            self.nonfinite_count += 1
            logger.warning("Loss is %s. Update skipped (patience %d/%d).",
                           loss, self.nonfinite_count,
                           self.run_opts.nonfinite_patience)
            if self.nonfinite_count > self.run_opts.nonfinite_patience:
                raise ValueError(
                    "Loss is not finite and patience is exhausted."
                )
            return self.avg_train_loss
        self._finite_losses += 1
        return loss

    def _flush_pending_loss(self):
        pending, self._pending_loss = self._pending_loss, None
        return None if pending is None else self._host_loss(pending)

    def _drain_loss_accum(self):
        """One host read of the device's (sum, count, non-finite) since
        the last; applies the nonfinite patience to the whole count.
        Returns ``(mean, count)``, or None where no loss was finite."""
        if self._loss_accum is None:
            return None
        self.host_syncs += 1
        total, n, bad = self._loss_accum.tolist()
        self._loss_accum = None
        if bad:
            self.nonfinite_count += int(bad)
            logger.warning("%d nonfinite loss step(s) in the last window; "
                           "updates skipped (patience %d/%d).", int(bad),
                           self.nonfinite_count,
                           self.run_opts.nonfinite_patience)
            if self.nonfinite_count > self.run_opts.nonfinite_patience:
                raise ValueError(
                    "Loss is not finite and patience is exhausted."
                )
        if n < 1:
            return None
        self._finite_losses += int(n)
        return total / n, int(n)

    @torch.no_grad()
    def evaluate_batch(self, batch, stage):
        """One forward-only batch; returns the loss as a Python float."""
        batch = self._prepare_batch(batch)
        with autocast(self.run_opts.eval_precision, self.device):
            predictions = self.compute_forward(batch, stage)
        loss, _ = self._objectives(predictions, batch, stage)
        return float(loss)

    # -- loops ------------------------------------------------------------
    def make_dataloader(self, dataset, stage, ckpt_prefix="dataloader-",
                        **loader_kwargs):
        """A loader of ``dataset`` (``loader_kwargs`` go to
        ``dataio.dataloader.make_dataloader``: ``batch_size``, ``shuffle``,
        ``sampler``, ``batch_sampler``, ``drop_last``, ``num_workers``,
        ``pin_memory`` (by default on a CUDA device), ``pad_to_multiple``,
        ``looped_nominal_epoch``); the TRAIN one is
        registered with the checkpointer, so that an epoch resumes on its
        next batch."""
        if isinstance(dataset, _LOADERS):
            return dataset
        loader_kwargs.setdefault("pin_memory", self.device.type == "cuda")
        dataloader = make_dataloader(dataset, **loader_kwargs)
        if (self.checkpointer is not None and ckpt_prefix is not None
                and stage == Stage.TRAIN):
            self.checkpointer.add_recoverable(ckpt_prefix + stage.name,
                                              dataloader)
        return dataloader

    def fit(self, epoch_counter, train_set, valid_set=None,
            progressbar=None, train_loader_kwargs={},
            valid_loader_kwargs={}):
        """The training loop: for each epoch, a TRAIN stage over
        ``train_set`` and a VALID stage over ``valid_set``."""
        if not isinstance(train_set, _LOADERS):
            train_set = self.make_dataloader(train_set, stage=Stage.TRAIN,
                                             **train_loader_kwargs)
        if valid_set is not None and not isinstance(valid_set, _LOADERS):
            valid_set = self.make_dataloader(
                valid_set, stage=Stage.VALID, ckpt_prefix=None,
                **valid_loader_kwargs,
            )
        self.on_fit_start()
        if progressbar is None:
            progressbar = not self.run_opts.noprogressbar
        for epoch in epoch_counter:
            self._fit_train(train_set, epoch, progressbar)
            self._fit_valid(valid_set, epoch, progressbar)
            if self.run_opts.debug and epoch == self.run_opts.debug_epochs:
                break
            if self._step_limit_reached():
                logger.info("Reached optimizer_step_limit (%d); stopping.",
                            self.run_opts.optimizer_step_limit)
                break

    def _debug_stop(self):
        opts = self.run_opts
        return opts.debug and self.step == opts.debug_batches

    def _step_limit_reached(self):
        limit = self.run_opts.optimizer_step_limit
        return limit is not None and self.optimizer_step >= limit

    def _add_train_loss(self, loss):
        """Fold a read loss, a float or ``(mean, count)``, into the
        epoch's running mean."""
        mean, n = loss if isinstance(loss, tuple) else (loss, 1)
        self._loss_count += n
        self.avg_train_loss += (n * (mean - self.avg_train_loss)
                                / self._loss_count)

    def _fit_train(self, train_set, epoch, enable):
        self.modules.train()
        self.on_stage_start(Stage.TRAIN, epoch)
        if hasattr(train_set, "set_epoch"):
            train_set.set_epoch(epoch)
        self.avg_train_loss = 0.0
        self.nonfinite_count = 0
        self._finite_losses = 0
        self._loss_count = 0
        self._pending_loss = None
        self._loss_accum = None
        profiler = None
        if self.run_opts.profile_training:
            profiler = prepare_profiler(
                self.run_opts.profile_warmup, self.run_opts.profile_steps,
                os.path.join(getattr(self.hparams, "output_folder", None)
                             or ".", "profiler_logs"),
            )
        log_every = self.run_opts.train_log_interval
        t = _progress(train_set, enable, f"Epoch {epoch} TRAIN")
        try:
            for self.step, batch in enumerate(t, start=1):
                if profiler is not None:
                    profiler.step()
                self.on_fit_batch_start(batch)
                loss = self.fit_batch(batch)
                if loss is not None:
                    self._add_train_loss(loss)
                if hasattr(t, "set_postfix"):
                    t.set_postfix(train_loss=self.avg_train_loss)
                if log_every and self.step % log_every == 0:
                    logger.info("epoch %s, batch %d: train loss %.4f",
                                epoch, self.step, self.avg_train_loss)
                if self._debug_stop():
                    break
                if self._step_limit_reached():
                    break
                if self._should_save_intra_epoch_ckpt():
                    self._save_intra_epoch_ckpt()
        finally:
            if profiler is not None:
                profiler.stop()
        loss = self._flush_pending_loss()
        if loss is None:
            loss = self._drain_loss_accum()
        if loss is not None:
            self._add_train_loss(loss)
        if self.nonfinite_count and not self._finite_losses:
            self.avg_train_loss = float("nan")
        self.on_stage_end(Stage.TRAIN, self.avg_train_loss, epoch)
        self.train_loss = self.avg_train_loss
        self.avg_train_loss = 0.0
        self.step = 0

    def _fit_valid(self, valid_set, epoch, enable):
        if valid_set is None:
            return
        self.modules.eval()
        self.on_stage_start(Stage.VALID, epoch)
        avg_valid_loss, n_finite = 0.0, 0
        t = _progress(valid_set, enable, f"Epoch {epoch} VALID")
        for self.step, batch in enumerate(t, start=1):
            loss = self.evaluate_batch(batch, stage=Stage.VALID)
            avg_valid_loss = self.update_average(loss, avg_valid_loss)
            n_finite += bool(np.isfinite(loss))
            if self._debug_stop():
                break
        avg_valid_loss = _nan_if_none_finite(avg_valid_loss, self.step,
                                             n_finite)
        self.on_stage_end(Stage.VALID, avg_valid_loss, epoch)
        self.step = 0

    def evaluate(self, test_set, max_key=None, min_key=None,
                 progressbar=None, test_loader_kwargs={}):
        """Evaluation over a test set, after recovering the best
        checkpoint by ``max_key``/``min_key``; returns the mean loss."""
        if progressbar is None:
            progressbar = not self.run_opts.noprogressbar
        if not isinstance(test_set, _LOADERS):
            test_set = self.make_dataloader(test_set, Stage.TEST,
                                            ckpt_prefix=None,
                                            **test_loader_kwargs)
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        self.modules.eval()
        self.on_stage_start(Stage.TEST, epoch=None)
        avg_test_loss, n_finite = 0.0, 0
        t = _progress(test_set, progressbar, "TEST")
        for self.step, batch in enumerate(t, start=1):
            loss = self.evaluate_batch(batch, stage=Stage.TEST)
            avg_test_loss = self.update_average(loss, avg_test_loss)
            n_finite += bool(np.isfinite(loss))
            if self._debug_stop():
                break
        avg_test_loss = _nan_if_none_finite(avg_test_loss, self.step,
                                            n_finite)
        self.on_stage_end(Stage.TEST, avg_test_loss, None)
        self.step = 0
        return avg_test_loss

    # -- checkpoints inside an epoch ---------------------------------------
    def _should_save_intra_epoch_ckpt(self):
        if self.checkpointer is None:
            return False
        if self.run_opts.ckpt_interval_minutes > 0:
            elapsed = (time.time() - self.last_ckpt_time) / 60.0
            if elapsed >= self.run_opts.ckpt_interval_minutes:
                return True
        steps = self.run_opts.ckpt_interval_steps
        return steps > 0 and self.optimizer_step % steps == 0

    def _save_intra_epoch_ckpt(self):
        self.checkpointer.save_and_keep_only(
            end_of_epoch=False, num_to_keep=1,
            ckpt_predicate=lambda c: INTRA_EPOCH_CKPT_FLAG in c.meta,
            meta={INTRA_EPOCH_CKPT_FLAG: True}, verbosity=False,
        )
        self.last_ckpt_time = time.time()

    def save_checkpoint(self, meta={}, end_of_epoch=True, **kwargs):
        """Save through the checkpointer, keeping what ``kwargs`` say."""
        return self.checkpointer.save_and_keep_only(
            meta=meta, end_of_epoch=end_of_epoch, **kwargs
        )

    def update_average(self, loss, avg_loss):
        """Running average over the current stage."""
        if np.isfinite(loss) and self.step > 0:
            avg_loss -= avg_loss / self.step
            avg_loss += loss / self.step
        return avg_loss


def _nan_if_none_finite(avg_loss, n_batches, n_finite):
    """A stage's mean loss, or NaN where it ran batches and none of their
    losses was finite."""
    return float("nan") if n_batches and not n_finite else avg_loss


class _FlatGrads:
    """The trainable parameters' ``.grad`` as views of one flat buffer a
    (dtype, device), so that the update's work on the gradients (zero,
    mask, norm, clip, the window's mean) is one kernel a buffer, however
    many parameters there are. Autograd adds into a ``.grad`` that
    exists, in place, so the views stay the gradients."""

    def __init__(self, params):
        self.params = list(params)
        groups = {}
        for p in self.params:
            groups.setdefault((p.dtype, p.device), []).append(p)
        self.buffers = []
        for (dtype, device), ps in groups.items():
            buf = torch.zeros(sum(p.numel() for p in ps), dtype=dtype,
                              device=device)
            offset = 0
            for p in ps:
                view = buf[offset:offset + p.numel()].view(p.shape)
                if p.grad is not None:
                    view.copy_(p.grad)
                p.grad = view
                offset += p.numel()
            self.buffers.append(buf)
        self.grads = [p.grad for p in self.params]

    def holds(self, params):
        """Whether ``params`` are this object's and still carry its
        views."""
        return len(params) == len(self.params) and all(
            p is q and p.grad is g
            for p, q, g in zip(params, self.params, self.grads)
        )

    def zero_(self):
        for b in self.buffers:
            b.zero_()

    def norm(self):
        """The global L2 norm, in float32, on the device."""
        norms = [torch.linalg.vector_norm(b, dtype=torch.float32)
                 for b in self.buffers]
        return norms[0] if len(norms) == 1 else torch.linalg.vector_norm(
            torch.stack(norms))

    def zero_where_not(self, flag):
        """Zero every gradient where the 0-d bool ``flag`` is false
        (NaN and inf included)."""
        for b in self.buffers:
            b.masked_fill_(~flag, 0.0)

    def mul_(self, scale):
        for b in self.buffers:
            b.mul_(scale)

    def copy_from(self, buffers):
        for b, src in zip(self.buffers, buffers):
            b.copy_(src)


class _MaskedUpdate:
    """``optimizer.step()`` kept only where a 0-d device flag is true,
    with no host read: the parameters and the optimizer's state are
    copied to flat buffers before the step and selected back after it
    (``torch.where``, exact either way). State that the optimizer makes
    at its first step counts as zero before it, which is Adam's and
    AdamW's initial state. The step must update its state in place and
    keep it on the parameters' device (``Brain.init_optimizers`` makes
    Adam and AdamW ``capturable`` on a CUDA device).

    Cost: the step runs on every micro-batch (the host does not know
    where a window ends, since a non-finite micro-batch stretches it),
    and about 9 bytes of traffic for each byte of parameters and state:
    the snapshot (2), the mirror of the new values (2), the select (3)
    and the copy back (2)."""

    def __init__(self):
        self._key = None
        self._groups = []  # [(tensors, snapshot views, mirror views,
        #                      snapshot flat, mirror flat)]

    @staticmethod
    def _tensors(optimizer, params):
        """For each parameter: the parameter, then its state tensors."""
        return [[p] + [v for v in optimizer.state.get(p, {}).values()
                       if torch.is_tensor(v)] for p in params]

    def _allocate(self, tensors, device):
        groups = {}
        for t in tensors:
            if t.device != device:
                raise ValueError(
                    f"the optimizer keeps a tensor on {t.device}, the "
                    f"parameters lie on {device}: the update is kept or "
                    f"undone on the device (make Adam or AdamW with "
                    f"capturable=True)"
                )
            groups.setdefault(t.dtype, []).append(t)
        self._groups = []
        for dtype, ts in groups.items():
            n = sum(t.numel() for t in ts)
            flats = [torch.empty(n, dtype=dtype, device=device)
                     for _ in range(2)]
            views = []
            for flat in flats:
                offset, vs = 0, []
                for t in ts:
                    vs.append(flat[offset:offset + t.numel()].view(t.shape))
                    offset += t.numel()
                views.append(vs)
            self._groups.append((ts, views[0], views[1], *flats))

    @torch.no_grad()
    def step(self, optimizer, params, keep):
        before = self._tensors(optimizer, params)
        flat = [t for ts in before for t in ts]
        key = tuple(map(id, flat))
        if key != self._key:
            self._allocate(flat, keep.device)
            self._key = key
        for ts, snap, _, _, _ in self._groups:
            torch._foreach_copy_(snap, ts)
        optimizer.step()
        for old, new in zip(before, self._tensors(optimizer, params)):
            if any(a is not b for a, b in zip(old, new)):
                raise RuntimeError(
                    "the optimizer replaced a state tensor in its step; "
                    "the masked update needs its state updated in place"
                )
            for t in new[len(old):]:  # made by this first step
                if t.device != keep.device:
                    self._allocate([t], keep.device)  # raises
                t.copy_(torch.where(keep, t, torch.zeros_like(t)))
        for ts, snap, mirror, snap_flat, mirror_flat in self._groups:
            torch._foreach_copy_(mirror, ts)
            torch.where(keep, mirror_flat, snap_flat, out=mirror_flat)
            torch._foreach_copy_(ts, mirror)


class _GroupOptimizers:
    """A dict ``opt_class``'s optimizers as one for ``fit``'s update:
    ``step`` steps each; ``state`` is all of theirs."""

    def __init__(self, optimizers):
        self.optimizers = optimizers

    @property
    def state(self):
        return collections.ChainMap(*(o.state
                                      for o in self.optimizers.values()))

    def step(self):
        for optimizer in self.optimizers.values():
            optimizer.step()


def forward_with_frozen_buffers(module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its buffers swapped for copies for
    the call, so that a BatchNorm in training mode normalises with the
    batch's statistics and its running statistics stay as they were, bit
    for bit (flax's ``apply`` with the ``batch_stats`` update thrown
    away). Gradients reach the parameters and the inputs as in a plain
    call."""
    buffers = {name: b.clone() for name, b in module.named_buffers()}
    return torch.func.functional_call(module, buffers, args, kwargs,
                                      strict=False)


def _progress(iterable, enable, desc):
    if enable:
        try:
            from tqdm import tqdm

            return tqdm(iterable, desc=desc, dynamic_ncols=True)
        except ImportError:
            pass
    return iterable
