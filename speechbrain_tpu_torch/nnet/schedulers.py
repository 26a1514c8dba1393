"""Learning-rate schedulers (port of ``NoamScheduler``,
``NewBobScheduler``, ``CyclicLRScheduler``, ``ReduceLROnPlateau`` and
``update_learning_rate``
from ``speechbrain_tpu/nnet/schedulers.py``).

A scheduler is stepped by hand and its learning rate written into a
``torch.optim`` optimizer with :func:`update_learning_rate`. Schedulers
are checkpointable.
"""

import json
import math

from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)


def update_learning_rate(optimizer, new_lr, group=None):
    """Set ``lr`` in ``optimizer``'s param groups: every group, or with
    ``group`` the one whose ``"name"`` entry equals it. Returns the
    optimizer.

    Example
    -------
    >>> import torch
    >>> p = torch.nn.Parameter(torch.zeros(2))
    >>> opt = torch.optim.SGD([{"params": [p], "name": "head"}], lr=1.0)
    >>> update_learning_rate(opt, 0.5, group="head").param_groups[0]["lr"]
    0.5
    """
    groups = optimizer.param_groups
    if group is not None:
        groups = [g for g in groups if g.get("name") == group]
        if not groups:
            raise ValueError(f"No param group {group!r} in the optimizer")
    for g in groups:
        g["lr"] = new_lr
    return optimizer


def _save_attrs(obj, path, attrs):
    with open(path, "w") as f:
        json.dump({a: getattr(obj, a) for a in attrs}, f)


def _load_attrs(obj, path, attrs):
    with open(path) as f:
        data = json.load(f)
    for a in attrs:
        if a in data:
            setattr(obj, a, data[a])


@register_checkpoint_hooks
class NoamScheduler:
    """Warm up, then decay as the inverse square root of the step.

    ``sch(None)`` advances one step and returns ``(old_lr, new_lr)``;
    ``sch(step)`` with an int returns that step's rate and changes
    nothing.

    Example
    -------
    >>> sch = NoamScheduler(lr_initial=1.0, n_warmup_steps=2)
    >>> _ = sch(None); _ = sch(None); old, new = sch(None)
    >>> round(new, 3) <= 1.0
    True
    """

    def __init__(self, lr_initial, n_warmup_steps, model_size=None):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.current_lr = lr_initial
        self.n_steps = 0
        self.normalize = n_warmup_steps**0.5
        if model_size is not None:
            self.normalize = model_size ** (-0.5)

    def _get_lr_scale(self, step):
        step = max(1, step)
        return self.normalize * min(
            step ** (-0.5), step * self.n_warmup_steps ** (-1.5)
        )

    def __call__(self, opt_or_step=None):
        if isinstance(opt_or_step, int):
            return self.lr_initial * self._get_lr_scale(opt_or_step)
        self.n_steps += 1
        old = self.current_lr
        self.current_lr = self.lr_initial * self._get_lr_scale(self.n_steps)
        return old, self.current_lr

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["current_lr", "n_steps"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        _load_attrs(self, path, ["current_lr", "n_steps"])


@register_checkpoint_hooks
class NewBobScheduler:
    """Anneal the rate by ``annealing_factor`` when the metric's relative
    improvement over the previous call falls below
    ``improvement_threshold``, after ``patient`` such calls.

    ``sch(metric)`` returns ``(old_value, new_value)``.

    Example
    -------
    >>> sch = NewBobScheduler(initial_value=1.0, annealing_factor=0.5)
    >>> sch(1.0)
    (1.0, 1.0)
    >>> sch(1.1)  # got worse -> anneal
    (1.0, 0.5)
    """

    def __init__(self, initial_value, annealing_factor=0.5,
                 improvement_threshold=0.0025, patient=0):
        self.hyperparam_value = initial_value
        self.annealing_factor = annealing_factor
        self.improvement_threshold = improvement_threshold
        self.patient = patient
        self.metric_values = []
        self.current_patient = self.patient

    def __call__(self, metric_value):
        old_value = new_value = self.hyperparam_value
        if len(self.metric_values) > 0:
            prev_metric = self.metric_values[-1]
            if prev_metric == 0:
                improvement = 0
            else:
                improvement = (prev_metric - metric_value) / prev_metric
            if improvement < self.improvement_threshold:
                if self.current_patient == 0:
                    new_value = old_value * self.annealing_factor
                    self.current_patient = self.patient
                else:
                    self.current_patient -= 1
        self.metric_values.append(float(metric_value))
        self.hyperparam_value = new_value
        return old_value, new_value

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path,
                    ["hyperparam_value", "metric_values", "current_patient"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        _load_attrs(self, path,
                    ["hyperparam_value", "metric_values", "current_patient"])


@register_checkpoint_hooks
class ReduceLROnPlateau:
    """Multiply the rate by ``factor`` (not below ``lr_min``) once the
    loss has stayed above its anchor, the last loss that did not, for
    more than ``patience`` calls; up to epoch ``dont_halve_until_epoch``
    the rate stays and every loss becomes the anchor. A halving resets
    the patience and keeps the anchor.

    ``sch(current_lr, epoch, current_loss)`` returns ``(current_lr,
    next_lr)``; the separation recipes call it at the end of each valid
    stage. Its losses, anchor and patience count are checkpointed.

    Example
    -------
    >>> sch = ReduceLROnPlateau(patience=1, dont_halve_until_epoch=1)
    >>> lr = 1.0
    >>> for epoch, loss in enumerate([5.0, 4.0, 4.5, 4.6, 4.7], start=1):
    ...     _, lr = sch(lr, epoch, loss)
    >>> lr
    0.5
    """

    def __init__(self, lr_min=1e-8, factor=0.5, patience=2,
                 dont_halve_until_epoch=65):
        self.lr_min = lr_min
        self.factor = factor
        self.patience = patience
        self.patience_counter = 0
        self.losses = []
        self.dont_halve_until_epoch = dont_halve_until_epoch
        self.anchor = 99999.0

    def __call__(self, current_lr, epoch, current_loss):
        if epoch <= self.dont_halve_until_epoch:
            next_lr = current_lr
            self.anchor = current_loss
        elif current_loss <= self.anchor:
            self.patience_counter = 0
            next_lr = current_lr
            self.anchor = current_loss
        elif self.patience_counter < self.patience:
            self.patience_counter += 1
            next_lr = current_lr
        else:
            next_lr = current_lr * self.factor
            self.patience_counter = 0
        next_lr = max(self.lr_min, next_lr)
        self.losses.append(float(current_loss))
        return current_lr, next_lr

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["losses", "anchor", "patience_counter"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        _load_attrs(self, path, ["losses", "anchor", "patience_counter"])


@register_checkpoint_hooks
class CyclicLRScheduler:
    """Cyclic learning rate between ``base_lr`` and ``max_lr`` by steps:
    a triangle of half-period ``step_size`` (``"triangular"``), its
    amplitude halved every cycle (``"triangular2"``), or scaled by
    ``gamma ** step`` (``"exp_range"``).

    ``sch(step)`` with an int returns that step's rate and changes
    nothing (the speaker recipes call it with the Brain's optimizer step
    at each valid stage); ``sch()`` advances its own count and returns
    ``(old_lr, new_lr)``.

    Example
    -------
    >>> sch = CyclicLRScheduler(base_lr=0.1, max_lr=0.3, step_size=4)
    >>> [round(sch(s), 3) for s in (0, 2, 4, 6, 8)]
    [0.1, 0.2, 0.3, 0.2, 0.1]
    """

    def __init__(self, base_lr=0.001, max_lr=0.006, step_size=2000,
                 mode="triangular", gamma=1.0):
        self.base_lr = base_lr
        self.max_lr = max_lr
        self.step_size = step_size
        self.mode = mode
        self.gamma = gamma
        self.clr_iterations = 0
        self.current_lr = base_lr

    def _clr(self, it):
        cycle = math.floor(1 + it / (2 * self.step_size))
        x = abs(it / self.step_size - 2 * cycle + 1)
        scale = 1.0
        if self.mode == "triangular2":
            scale = 1 / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            scale = self.gamma**it
        return (self.base_lr
                + (self.max_lr - self.base_lr) * max(0, 1 - x) * scale)

    def __call__(self, opt_or_step=None):
        if isinstance(opt_or_step, int):
            return self._clr(opt_or_step)
        self.clr_iterations += 1
        old = self.current_lr
        self.current_lr = self._clr(self.clr_iterations)
        return old, self.current_lr

    @mark_as_saver
    def _save(self, path):
        _save_attrs(self, path, ["clr_iterations", "current_lr"])

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        _load_attrs(self, path, ["clr_iterations", "current_lr"])
