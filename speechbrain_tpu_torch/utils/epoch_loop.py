"""Checkpointable epoch counters (port of ``EpochCounter`` and
``EpochCounterWithStopper`` from ``speechbrain_tpu/utils/epoch_loop.py``).

Example
-------
>>> ec = EpochCounter(2)
>>> [e for e in ec]
[1, 2]
"""

import logging

from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)

logger = logging.getLogger(__name__)


@register_checkpoint_hooks
class EpochCounter:
    """Iterator that counts epochs 1..limit and checkpoints its position,
    so that a resumed experiment goes on from the right epoch."""

    def __init__(self, limit):
        self.current = 0
        self.limit = int(limit)

    def __iter__(self):
        return self

    def __next__(self):
        if self.current < self.limit:
            self.current += 1
            logger.info("Going into epoch %d", self.current)
            return self.current
        raise StopIteration

    @mark_as_saver
    def _save(self, path):
        with open(path, "w") as fo:
            fo.write(str(self.current))

    @mark_as_loader
    def _recover(self, path, end_of_epoch=True):
        with open(path) as fi:
            saved_value = int(fi.read())
        # a checkpoint from inside an epoch redoes that epoch
        self.current = saved_value if end_of_epoch else saved_value - 1


class EpochCounterWithStopper(EpochCounter):
    """An :class:`EpochCounter` that stops early: call
    ``update_metric(value)`` once an epoch; after ``limit_warmup`` epochs,
    ``limit_to_stop`` epochs in a row without improvement (``direction``
    ``"min"`` or ``"max"``) end the iteration. Its checkpoint is the
    counter's (the epoch), as in the JAX package.

    Example
    -------
    >>> ec = EpochCounterWithStopper(10, limit_to_stop=2, limit_warmup=0,
    ...                              direction="min")
    >>> seen = []
    >>> for epoch in ec:
    ...     seen.append(epoch)
    ...     ec.update_metric(1.0)
    >>> seen
    [1, 2, 3]
    """

    def __init__(self, limit, limit_to_stop, limit_warmup, direction):
        super().__init__(limit)
        if limit_to_stop < 0:
            raise ValueError("Stopper 'limit_to_stop' must be >= 0")
        if limit_warmup < 0:
            raise ValueError("Stopper 'limit_warmup' must be >= 0")
        if direction not in ("min", "max"):
            raise ValueError("Stopper direction must be 'min' or 'max'")
        self.limit_to_stop = limit_to_stop
        self.limit_warmup = limit_warmup
        self.direction = direction
        self.min_delta = 0.0
        self.best_limit = float("inf") if direction == "min" \
            else -float("inf")
        self.patience_counter = 0
        self.should_stop = False

    def _improves(self, value):
        if self.direction == "min":
            return value < self.best_limit - self.min_delta
        return value > self.best_limit + self.min_delta

    def __next__(self):
        if self.should_stop:
            logger.info("Early stopping at epoch %d", self.current)
            raise StopIteration
        return super().__next__()

    def update_metric(self, current_metric):
        """Track the epoch's metric; sets ``should_stop`` when the
        patience is spent."""
        if self.current > self.limit_warmup:
            if self._improves(current_metric):
                self.best_limit = current_metric
                self.patience_counter = 0
            else:
                self.patience_counter += 1
                self.should_stop = \
                    self.patience_counter >= self.limit_to_stop
