"""Dynamic chunk training configuration (port of
``speechbrain_tpu/utils/dynamic_chunk_training.py``): chunked attention
for streaming-capable encoders, with a chunk size and left context drawn
for every training batch.

The sampler draws from numpy's ``default_rng(seed)`` in the JAX package's
call order, so one seed gives the same configurations in both packages.

Example
-------
>>> from speechbrain_tpu_torch.core import Stage
>>> sampler = DynChunkTrainConfigRandomSampler(
...     valid_config=DynChunkTrainConfig(24, 4))
>>> sampler(Stage.VALID)
DynChunkTrainConfig(chunk_size=24, left_context_size=4)
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DynChunkTrainConfig:
    """A chunk size, in encoder frames (after the front end's
    subsampling), and a left context in chunks; ``left_context_size``
    None is an unlimited left context."""

    chunk_size: int
    left_context_size: int = None

    def is_infinite_left_context(self):
        return self.left_context_size is None

    def left_context_size_frames(self):
        """The left context in frames, None where it is unlimited."""
        if self.left_context_size is None:
            return None
        return self.chunk_size * self.left_context_size


class DynChunkTrainConfigRandomSampler:
    """A :class:`DynChunkTrainConfig` for each batch: in training, with
    probability ``chunkwise_prob`` a chunked one (chunk size drawn from
    ``[chunk_size_min, chunk_size_max]``; with probability
    ``limited_left_context_prob`` a left context drawn from
    ``[left_context_chunks_min, left_context_chunks_max]``, else an
    unlimited one), else None (full context); ``valid_config`` and
    ``test_config`` for the other stages."""

    def __init__(self, chunkwise_prob=0.6, chunk_size_min=8,
                 chunk_size_max=32, limited_left_context_prob=0.75,
                 left_context_chunks_min=2, left_context_chunks_max=32,
                 test_config=None, valid_config=None, seed=875):
        self.chunkwise_prob = chunkwise_prob
        self.chunk_size_min = chunk_size_min
        self.chunk_size_max = chunk_size_max
        self.limited_left_context_prob = limited_left_context_prob
        self.left_context_chunks_min = left_context_chunks_min
        self.left_context_chunks_max = left_context_chunks_max
        self.test_config = test_config
        self.valid_config = valid_config
        self._rng = np.random.default_rng(seed)

    def __call__(self, stage):
        from speechbrain_tpu_torch.core import Stage

        if stage == Stage.TRAIN:
            if self._rng.random() < self.chunkwise_prob:
                chunk_size = int(self._rng.integers(
                    self.chunk_size_min, self.chunk_size_max + 1))
                if self._rng.random() < self.limited_left_context_prob:
                    left = int(self._rng.integers(
                        self.left_context_chunks_min,
                        self.left_context_chunks_max + 1))
                else:
                    left = None
                return DynChunkTrainConfig(chunk_size, left)
            return None
        if stage == Stage.VALID:
            return self.valid_config
        return self.test_config
