"""Samplers (port of ``ReproducibleRandomSampler`` and
``SequentialSampler`` from ``speechbrain_tpu/dataio/sampler.py``).

The shuffled order is the JAX package's: a permutation drawn by
``np.random.default_rng(seed + epoch)``, so that the two packages train
on the same batches for the same seed.
"""

import numpy as np
import torch


class ReproducibleRandomSampler(torch.utils.data.Sampler):
    """Shuffles indices deterministically from (seed, epoch).

    Call ``set_epoch`` each epoch for a fresh but reproducible order.

    Example
    -------
    >>> s = ReproducibleRandomSampler(list(range(5)), seed=17)
    >>> a = list(s); s.set_epoch(1); b = list(s)
    >>> sorted(a) == sorted(b) == list(range(5))
    True
    """

    def __init__(self, data_source, seed=563375142, epoch=0):
        if not isinstance(seed, int):
            raise ValueError(f"Random seed must be an integer, got {seed}")
        self.data_source = data_source
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.data_source)).tolist())

    def __len__(self):
        return len(self.data_source)


class SequentialSampler(torch.utils.data.Sampler):
    """Indices in order 0..n-1."""

    def __init__(self, data_source):
        self.data_source = data_source

    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)
