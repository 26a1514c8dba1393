"""Samplers (port of ``ReproducibleRandomSampler``, ``SequentialSampler``,
``ReproducibleWeightedRandomSampler``, ``BalancingDataSampler``,
``ConcatDatasetBatchSampler`` and ``DynamicBatchSampler`` from
``speechbrain_tpu/dataio/sampler.py``).

Every random draw is the JAX package's: numpy's
``np.random.default_rng(seed + epoch)``, so that the two packages train on
the same batches for the same seed and epoch. ``DistributedSamplerWrapper``
(several processes) is not ported yet.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


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


class ReproducibleWeightedRandomSampler(torch.utils.data.Sampler):
    """``num_samples`` indices drawn with probabilities proportional to
    ``weights`` (with replacement by default), reproducible from (seed,
    epoch).

    Example
    -------
    >>> s = ReproducibleWeightedRandomSampler([0.0, 1.0, 0.0], 4)
    >>> list(s)
    [1, 1, 1, 1]
    """

    def __init__(self, weights, num_samples, replacement=True,
                 seed=129491412, epoch=0):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        p = self.weights / self.weights.sum()
        return iter(rng.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BalancingDataSampler(ReproducibleWeightedRandomSampler):
    """Draws the examples of ``dataset`` with weights inversely
    proportional to the frequency of their value of ``key``, so that each
    value comes up about equally often."""

    def __init__(self, dataset, key, num_samples=None, replacement=True,
                 seed=563375142, epoch=0):
        self.dataset = dataset
        self.key = key
        with dataset.output_keys_as([key]):
            values = [item[key] for item in dataset]
        _, inverse, counts = np.unique(np.asarray(values),
                                       return_inverse=True,
                                       return_counts=True)
        super().__init__(1.0 / counts[inverse], num_samples or len(dataset),
                         replacement, seed, epoch)


class ConcatDatasetBatchSampler(torch.utils.data.Sampler):
    """Batches that take ``batch_sizes[i]`` examples from each of the
    ``samplers`` in turn, as indices into the datasets concatenated in
    that order; as many batches as the shortest sampler gives."""

    def __init__(self, samplers, batch_sizes, epoch=0):
        if not isinstance(samplers, (list, tuple)) or not isinstance(
                batch_sizes, (list, tuple)):
            raise ValueError("samplers and batch_sizes must be lists")
        if len(batch_sizes) != len(samplers):
            raise ValueError(
                "samplers and batch_sizes must have the same length")
        self.batch_sizes = batch_sizes
        self.samplers = samplers
        # where each dataset starts in the concatenated index space
        self.offsets = [0] + np.cumsum([len(s) for s in samplers])[:-1] \
            .tolist()
        self.epoch = epoch
        self.set_epoch(epoch)

    def set_epoch(self, epoch):
        for s in self.samplers:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def __iter__(self):
        iterators = [iter(s) for s in self.samplers]
        for _ in range(len(self)):
            batch = []
            for it, size, offset in zip(iterators, self.batch_sizes,
                                        self.offsets):
                batch.extend(offset + next(it) for _ in range(size))
            yield batch

    def __len__(self):
        return int(min(len(s) // b
                       for s, b in zip(self.samplers, self.batch_sizes)))


class DynamicBatchSampler(torch.utils.data.Sampler):
    """Batches of examples of similar length, at most ``max_batch_length``
    of them in all (in the lengths' unit, seconds by default).

    Examples go to length buckets whose right edges are
    ``bucket_boundaries``, or, given ``num_buckets``, the lengths'
    quantiles with ``max(longest, max_batch_length)`` as the last edge. A
    bucket's batch is full at ``int(max_batch_length / edge)`` examples
    (at least 1; at most ``max_batch_ex``), a length past the last edge
    goes alone. Examples are taken in an order drawn by
    ``np.random.default_rng(seed + epoch)`` (``shuffle``) or in dataset
    order; the batches are then permuted by the same generator
    (``batch_ordering="random"``) or sorted by their longest example
    (``"ascending"``, ``"descending"``). The JAX package's sampler, draw
    for draw: the same dataset, seed and epoch give the same batches.

    Example
    -------
    >>> class Lengths:
    ...     data_ids = ["a", "b", "c", "d"]
    ...     data = {"a": {"duration": 1.0}, "b": {"duration": 2.0},
    ...             "c": {"duration": 1.0}, "d": {"duration": 2.0}}
    ...     def __len__(self):
    ...         return 4
    >>> s = DynamicBatchSampler(Lengths(), 4.0, bucket_boundaries=[1.0, 2.0],
    ...                         shuffle=False, batch_ordering="ascending")
    >>> list(s)
    [[0, 2], [1, 3]]
    """

    def __init__(self, dataset, max_batch_length, num_buckets=None,
                 length_func=lambda x: x["duration"], shuffle=True,
                 batch_ordering="random", max_batch_ex=None,
                 bucket_boundaries=(), lengths_list=None, seed=42, epoch=0,
                 drop_last=False, verbose=False):
        self._dataset = dataset
        if lengths_list is not None:
            lengths = list(lengths_list)
        else:
            lengths = [length_func(dataset.data[data_id])
                       for data_id in dataset.data_ids]
        self._ex_lengths = {str(i): length for i, length in
                            enumerate(lengths)}
        if bucket_boundaries:
            if not all(x >= 0 for x in bucket_boundaries):
                raise ValueError("All bucket boundaries should be >= 0")
            if len(set(bucket_boundaries)) != len(bucket_boundaries):
                raise ValueError("Bucket boundaries must be unique")
            self._bucket_boundaries = np.array(sorted(bucket_boundaries))
        else:
            if num_buckets is None:
                raise ValueError(
                    "Need either bucket_boundaries or num_buckets")
            self._bucket_boundaries = np.array(
                self._get_boundaries_through_warping(max_batch_length,
                                                     num_buckets))
        if batch_ordering not in ("random", "ascending", "descending"):
            raise ValueError(f"Unknown batch_ordering {batch_ordering}")
        self._max_batch_length = max_batch_length
        self._shuffle_ex = shuffle
        self._batch_ordering = batch_ordering
        self._seed = seed
        self._drop_last = drop_last
        self._max_batch_ex = (max_batch_ex if max_batch_ex is not None
                              else np.inf)
        self._bucket_lens = [
            max(1, int(max_batch_length / edge))
            for edge in self._bucket_boundaries
        ] + [1]
        self._epoch = epoch
        self._generate_batches()
        if verbose:
            logger.info("DynamicBatchSampler: %d batches",
                        len(self._batches))

    def _get_boundaries_through_warping(self, max_batch_length,
                                        num_quantiles):
        lengths = np.array(sorted(self._ex_lengths.values()))
        qs = np.linspace(0, 1, num_quantiles + 1)[1:-1]
        edges = np.quantile(lengths, qs).tolist()
        edges.append(max(lengths.max(), max_batch_length))
        return list(dict.fromkeys(edges))  # unique, in order

    def get_durations(self, batch):
        """The lengths of a batch's examples."""
        return [self._ex_lengths[str(i)] for i in batch]

    def _generate_batches(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        n = len(self._ex_lengths)
        order = rng.permutation(n) if self._shuffle_ex else np.arange(n)
        open_batches = [[] for _ in self._bucket_lens]
        batches = []
        for idx in order:
            bucket = int(np.searchsorted(self._bucket_boundaries,
                                         self._ex_lengths[str(idx)]))
            open_batches[bucket].append(int(idx))
            if len(open_batches[bucket]) >= min(self._bucket_lens[bucket],
                                                self._max_batch_ex):
                batches.append(open_batches[bucket])
                open_batches[bucket] = []
        if not self._drop_last:
            batches.extend(b for b in open_batches if b)
        if self._batch_ordering == "random":
            batches = [batches[i] for i in rng.permutation(len(batches))]
        else:
            batches.sort(key=lambda b: max(self.get_durations(b)),
                         reverse=self._batch_ordering == "descending")
        self._batches = batches

    def __iter__(self):
        return iter(self._batches)

    def set_epoch(self, epoch):
        self._epoch = epoch
        self._generate_batches()

    def __len__(self):
        return len(self._batches)
