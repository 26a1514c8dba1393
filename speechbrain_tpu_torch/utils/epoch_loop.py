"""Checkpointable epoch counter (port of ``EpochCounter`` from
``speechbrain_tpu/utils/epoch_loop.py``).

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
