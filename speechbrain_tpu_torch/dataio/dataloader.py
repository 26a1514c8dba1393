"""Data loading (port of ``make_dataloader``, ``SaveableDataLoader`` and
``LoopedLoader`` from ``speechbrain_tpu/dataio/dataloader.py``): batches
of a dataset, collated by ``PaddedBatch``, with the position inside an
epoch checkpointable, so that training resumes on the exact next batch.

With ``num_workers > 0`` the batches are read and collated ahead, in that
many threads, while the caller consumes the earlier ones: results come in
order, and at most ``2 * num_workers`` batches are in flight. Threads
overlap where the work releases the GIL: the native WAV decoder does,
``PaddedBatch``'s per-example Python does not.
"""

import collections
import json
from concurrent.futures import ThreadPoolExecutor

from speechbrain_tpu_torch.dataio.batch import BatchsizeGuesser, PaddedBatch
from speechbrain_tpu_torch.dataio.sampler import (
    ReproducibleRandomSampler,
    SequentialSampler,
)
from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)


def make_dataloader(dataset, looped_nominal_epoch=None, pad_to_multiple=1,
                    **loader_kwargs):
    """A :class:`SaveableDataLoader` whose batches are
    :class:`PaddedBatch`\\ es, their time axes rounded up by
    ``pad_to_multiple`` (an int, or ``{key: multiple}``), unless a
    ``collate_fn`` is given; wrapped in a :class:`LoopedLoader` of
    ``looped_nominal_epoch`` batches an epoch where that is given.

    Example
    -------
    >>> import numpy as np
    >>> data = [{"x": np.ones(n)} for n in (3, 5, 2)]
    >>> loader = make_dataloader(data, batch_size=2, pad_to_multiple=4)
    >>> [tuple(b.x.data.shape) for b in loader]
    [(2, 8), (1, 4)]
    """
    if "collate_fn" not in loader_kwargs:
        loader_kwargs["collate_fn"] = lambda examples: PaddedBatch(
            examples, pad_to_multiple=pad_to_multiple
        )
    loader = SaveableDataLoader(dataset, **loader_kwargs)
    if looped_nominal_epoch is not None:
        loader = LoopedLoader(loader, looped_nominal_epoch)
    return loader


@register_checkpoint_hooks
class SaveableDataLoader:
    """Iterates a dataset in batches; its position inside an epoch is
    saved and restored.

    Arguments
    ---------
    dataset : indexable
    batch_size : int
    shuffle : bool
        Take the examples in the order of a
        :class:`ReproducibleRandomSampler` seeded with ``seed``.
    sampler : iterable, optional
        Yields example indices (in place of ``shuffle``).
    batch_sampler : iterable, optional
        Yields lists of example indices (in place of ``batch_size``,
        ``shuffle``, ``sampler`` and ``drop_last``).
    collate_fn : callable
    drop_last : bool
        Leave out a last batch smaller than ``batch_size``.
    num_workers : int
        Read-ahead threads; 0 reads in the caller's thread.
    pin_memory : bool
        Put the tensors of each batch that has a ``pin_memory()`` method
        (``PaddedBatch``) in page-locked memory, in the thread that
        collates it, so that its upload to a CUDA device can be queued
        without waiting.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, sampler=None,
                 batch_sampler=None, collate_fn=None, drop_last=False,
                 num_workers=0, pin_memory=False, seed=563375142):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or (lambda x: x)
        self.batch_sampler = batch_sampler
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        if batch_sampler is None and sampler is None:
            sampler = (ReproducibleRandomSampler(dataset, seed=seed)
                       if shuffle else SequentialSampler(dataset))
        self.sampler = None if batch_sampler is not None else sampler
        self._recovery_skip = 0  # batches to skip after a resume
        self._num_batches_yielded = 0

    def set_epoch(self, epoch):
        """Forward the epoch to the (batch) sampler."""
        target = (self.batch_sampler if self.batch_sampler is not None
                  else self.sampler)
        if hasattr(target, "set_epoch"):
            target.set_epoch(epoch)

    def _batch_indices(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _make_batch(self, indices):
        batch = self.collate_fn([self.dataset[i] for i in indices])
        if self.pin_memory and hasattr(batch, "pin_memory"):
            return batch.pin_memory()
        return batch

    def __iter__(self):
        skip = self._recovery_skip
        self._recovery_skip = 0
        self._num_batches_yielded = skip
        indices = (ind for b, ind in enumerate(self._batch_indices())
                   if b >= skip)
        if self.num_workers > 0:
            batches = _threaded_map(self._make_batch, indices,
                                    self.num_workers)
        else:
            batches = map(self._make_batch, indices)
        try:
            for batch in batches:
                # counts what the caller took, not what was read ahead
                self._num_batches_yielded += 1
                yield batch
        finally:
            if hasattr(batches, "close"):
                batches.close()
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


def _threaded_map(fn, iterable, num_workers, prefetch=2):
    """``map(fn, iterable)`` in ``num_workers`` threads, in order, with at
    most ``num_workers * prefetch`` calls submitted ahead of the one
    being consumed. Closing the generator (a ``break`` in the caller)
    cancels what has not started and waits for what has, so that no
    thread outlives the epoch."""
    window = num_workers * prefetch
    pending = collections.deque()
    with ThreadPoolExecutor(max_workers=num_workers,
                            thread_name_prefix="loader") as pool:
        try:
            for item in iterable:
                pending.append(pool.submit(fn, item))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for future in pending:
                future.cancel()


@register_checkpoint_hooks
class LoopedLoader:
    """Iterates ``loader`` in nominal epochs of ``epoch_length`` batches,
    starting it again where it runs out, and checkpoints the position:
    for a stream, or a corpus whose epochs are too long to wait for."""

    def __init__(self, loader, epoch_length, batchsize_fn=None):
        self.loader = loader
        self.iterator = None
        self.epoch_length = epoch_length
        self.step = 0
        self.total_steps = 0
        self.total_samples = 0
        self.batchsize_fn = batchsize_fn or BatchsizeGuesser()

    def __iter__(self):
        if self.iterator is None:
            self.iterator = iter(self.loader)
        return self

    def __next__(self):
        if self.step < self.epoch_length:
            self.step += 1
            self.total_steps += 1
            try:
                batch = next(self.iterator)
            except StopIteration:
                self.iterator = iter(self.loader)
                batch = next(self.iterator)
            self.total_samples += self.batchsize_fn(batch)
            return batch
        self.step = 0
        raise StopIteration

    def __len__(self):
        return self.epoch_length

    @mark_as_saver
    def _save(self, path):
        with open(path, "w") as f:
            json.dump({"step": self.step, "total_steps": self.total_steps,
                       "total_samples": self.total_samples}, f)

    @mark_as_loader
    def _load(self, path, end_of_epoch=True):
        with open(path) as f:
            saved = json.load(f)
        self.step = saved["step"]
        self.total_steps = saved["total_steps"]
        self.total_samples = saved["total_samples"]
        if not end_of_epoch and self.step == 0:
            # a checkpoint at step 0 inside an epoch acts as its end
            self.step = self.epoch_length
