"""Data loading (port of ``make_dataloader`` and ``SaveableDataLoader``
from ``speechbrain_tpu/dataio/dataloader.py``): batches of a dataset,
collated by ``PaddedBatch``, with the position inside an epoch
checkpointable, so that training resumes on the exact next batch.
Examples are read and collated on the host, in the caller's thread.
"""

import json

from speechbrain_tpu_torch.dataio.batch import PaddedBatch
from speechbrain_tpu_torch.dataio.sampler import (
    ReproducibleRandomSampler,
    SequentialSampler,
)
from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)


def make_dataloader(dataset, pad_to_multiple=1, **loader_kwargs):
    """A :class:`SaveableDataLoader` whose batches are
    :class:`PaddedBatch`\\ es, their time axes rounded up by
    ``pad_to_multiple`` (an int, or ``{key: multiple}``).

    Example
    -------
    >>> import numpy as np
    >>> data = [{"x": np.ones(n)} for n in (3, 5, 2)]
    >>> loader = make_dataloader(data, batch_size=2, pad_to_multiple=4)
    >>> [tuple(b.x.data.shape) for b in loader]
    [(2, 8), (1, 4)]
    """
    return SaveableDataLoader(
        dataset,
        collate_fn=lambda examples: PaddedBatch(
            examples, pad_to_multiple=pad_to_multiple
        ),
        **loader_kwargs,
    )


@register_checkpoint_hooks
class SaveableDataLoader:
    """Iterates a dataset in batches of ``batch_size`` (the last one may
    be smaller), in order or, with ``shuffle``, in the order of a
    :class:`ReproducibleRandomSampler` seeded with ``seed``; its position
    inside an epoch is saved and restored."""

    def __init__(self, dataset, batch_size=1, shuffle=False,
                 collate_fn=None, seed=563375142):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda x: x)
        self.sampler = (ReproducibleRandomSampler(dataset, seed=seed)
                        if shuffle else SequentialSampler(dataset))
        self._recovery_skip = 0  # batches to skip after a resume
        self._num_batches_yielded = 0

    def set_epoch(self, epoch):
        """Forward the epoch to the sampler (a fresh shuffled order)."""
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _batch_indices(self):
        order = list(self.sampler)
        for start in range(0, len(order), self.batch_size):
            yield order[start:start + self.batch_size]

    def __len__(self):
        return -(-len(self.sampler) // self.batch_size)

    def __iter__(self):
        skip = self._recovery_skip
        self._recovery_skip = 0
        self._num_batches_yielded = skip
        for b, indices in enumerate(self._batch_indices()):
            if b < skip:
                continue
            batch = self.collate_fn([self.dataset[i] for i in indices])
            self._num_batches_yielded += 1
            yield batch
        self._num_batches_yielded = 0  # a clean end of epoch

    @mark_as_saver
    def _save(self, path):
        with open(path, "w") as f:
            json.dump({"num_batches": self._num_batches_yielded}, f)

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        with open(path) as f:
            saved = json.load(f)
        self._recovery_skip = 0 if end_of_epoch \
            else saved.get("num_batches", 0)
