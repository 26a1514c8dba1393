"""Batch collation with right-padding and relative lengths (port of
``PaddedBatch``/``PaddedData`` from ``speechbrain_tpu/dataio/batch.py``),
producing torch tensors.

``PaddedData`` holds ``(data, lengths)`` with *relative* lengths
(length / padded length), the toolkit-wide convention.
``pad_to_multiple`` rounds a key's padded time axis up to a multiple, so
that few distinct shapes reach the device.
"""

import collections

import numpy as np
import torch

from speechbrain_tpu_torch.utils.data_utils import batch_pad_right, round_up

PaddedData = collections.namedtuple("PaddedData", ["data", "lengths"])


def _is_arrayable(value):
    if isinstance(value, (np.ndarray, np.generic, float, int, bool,
                          torch.Tensor)):
        return True
    return isinstance(value, (list, tuple)) and len(value) and isinstance(
        value[0], (int, float, np.ndarray, np.generic)
    )


def _as_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class PaddedBatch:
    """Collates a list of example dicts: each array-like value is padded
    on the right with zeros and stacked into a tensor, beside its
    relative lengths (``PaddedData``); other values stay lists.
    ``pad_to_multiple`` (an int, or ``{key: multiple}``) rounds the padded
    length of the time axis up to a multiple.

    Example
    -------
    >>> batch = PaddedBatch([
    ...     {"id": "ex1", "val": np.array([1.0])},
    ...     {"id": "ex2", "val": np.array([2.0, 1.0])},
    ... ])
    >>> batch.id
    ['ex1', 'ex2']
    >>> batch.val.data.shape
    torch.Size([2, 2])
    >>> batch.val.lengths.tolist()
    [0.5, 1.0]
    """

    def __init__(self, examples, pad_to_multiple=1):
        self.__length = len(examples)
        self.__keys = list(examples[0].keys())
        self.__padded_keys = []
        for key in self.__keys:
            values = [example[key] for example in examples]
            if not _is_arrayable(values[0]):
                setattr(self, key, values)
                continue
            arrays = [_as_numpy(v) for v in values]
            mult = (pad_to_multiple.get(key, 1)
                    if isinstance(pad_to_multiple, dict)
                    else pad_to_multiple or 1)
            if mult > 1 and arrays[0].ndim >= 1:
                # the padded time axis rounded up to the bucket; the
                # relative lengths are taken against it
                target_t = round_up(max(a.shape[0] for a in arrays), mult)
                padded = np.stack([
                    np.pad(a, [(0, target_t - a.shape[0])]
                           + [(0, 0)] * (a.ndim - 1))
                    for a in arrays
                ])
                lengths = np.asarray(
                    [a.shape[0] / target_t for a in arrays], np.float32
                )
            else:
                padded, lengths = batch_pad_right(arrays)
            setattr(self, key, PaddedData(torch.from_numpy(padded),
                                          torch.from_numpy(lengths)))
            self.__padded_keys.append(key)

    def __len__(self):
        return self.__length

    @property
    def batchsize(self):
        """The number of examples."""
        return self.__length

    def __getitem__(self, key):
        if key in self.__keys:
            return getattr(self, key)
        raise KeyError(f"Batch doesn't have key: {key}")

    def __iter__(self):
        """The values in key order, so that a batch unpacks:

        >>> batch = PaddedBatch([{"x": np.array([1.0]), "y": np.array([2.0])}])
        >>> x, y = batch
        >>> tuple(x.data.shape)
        (1, 1)
        """
        return iter(getattr(self, key) for key in self.__keys)

    def pin_memory(self):
        """Move the padded keys' tensors to page-locked host memory, in
        place; returns the batch."""
        for key in self.__padded_keys:
            data, lengths = getattr(self, key)
            setattr(self, key, PaddedData(data.pin_memory(),
                                          lengths.pin_memory()))
        return self

    def to(self, device="cuda", non_blocking=False):
        """Move the padded keys' tensors to ``device``, in place; returns
        the batch."""
        for key in self.__padded_keys:
            data, lengths = getattr(self, key)
            setattr(self, key, PaddedData(
                data.to(device, non_blocking=non_blocking),
                lengths.to(device, non_blocking=non_blocking),
            ))
        return self


class BatchsizeGuesser:
    """The number of examples in whatever a loader yields: a batch's
    ``batchsize``, the length of a dict's first value, of a sequence's
    first element, or of the batch itself (the first that works is kept),
    else 1."""

    def __init__(self):
        self.method = None

    def __call__(self, batch):
        if self.method is not None:
            try:
                return self.method(batch)
            except (AttributeError, TypeError, KeyError, IndexError):
                pass
        for method in (lambda b: b.batchsize,
                       lambda b: len(next(iter(b.values()))),
                       lambda b: len(b[0]),
                       len):
            try:
                size = method(batch)
            except (AttributeError, TypeError, KeyError, IndexError,
                    StopIteration):
                continue
            self.method = method
            return size
        self.method = lambda b: 1
        return 1
