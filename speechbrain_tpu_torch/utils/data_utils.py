"""Data utilities (port of part of ``speechbrain_tpu/utils/data_utils.py``):
host-side padding for batch collation (``pad_right_to``,
``batch_pad_right``, ``round_up``, on numpy), ``undo_padding`` and
``pad_time_to_multiple`` on tensors."""

import numpy as np
import torch
import torch.nn.functional as F


def pad_right_to(array, target_shape, value=0):
    """Pad a numpy array on the right of each axis up to ``target_shape``.

    Returns the padded array and, for each axis, the fraction of it that
    holds the original data.
    """
    array = np.asarray(array)
    if len(target_shape) != array.ndim:
        raise ValueError(f"target {target_shape} for shape {array.shape}")
    pads, valid_percent = [], []
    for i, target in enumerate(target_shape):
        if target < array.shape[i]:
            raise ValueError(
                f"Target shape {target_shape} smaller than source "
                f"{array.shape}"
            )
        pads.append((0, target - array.shape[i]))
        valid_percent.append(array.shape[i] / target)
    padded = np.pad(array, pads, mode="constant", constant_values=value)
    return padded, valid_percent


def batch_pad_right(arrays, mode="constant", value=0, val_index=0):
    """Pad numpy arrays to their largest shape and stack them.

    Returns the stacked array and each array's relative length along axis
    ``val_index`` (its length over the largest), float32.

    Example
    -------
    >>> data, lens = batch_pad_right([np.ones(2), np.ones(4)])
    >>> data.shape, lens.tolist()
    ((2, 4), [0.5, 1.0])
    """
    if not len(arrays):
        raise ValueError("Expected at least one array")
    arrays = [np.asarray(x) for x in arrays]
    ndim = arrays[0].ndim
    if any(x.ndim != ndim for x in arrays):
        raise ValueError("All arrays must have the same number of dims")
    if ndim == 0:
        return np.stack(arrays), np.ones(len(arrays), dtype=np.float32)
    max_shape = [max(x.shape[d] for x in arrays) for d in range(ndim)]
    batched, valid = [], []
    for x in arrays:
        padded, valid_percent = pad_right_to(x, max_shape, value=value)
        batched.append(padded)
        valid.append(valid_percent[val_index])
    return np.stack(batched), np.asarray(valid, dtype=np.float32)


def undo_padding(batch, lengths):
    """Each example of a padded batch as a Python list, cut to its
    length: ``round(rel_len * padded_len)`` entries. ``batch`` and
    ``lengths`` may be tensors on any device (moved to the host once) or
    numpy arrays.

    Example
    -------
    >>> undo_padding(np.array([[1, 2, 0], [3, 4, 5]]), np.array([2/3, 1.0]))
    [[1, 2], [3, 4, 5]]
    """
    if isinstance(batch, torch.Tensor):
        batch = batch.cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    batch = np.asarray(batch)
    lengths = np.asarray(lengths)
    batch_max_len = batch.shape[1]
    return [seq[:int(round(float(rel_len) * batch_max_len))].tolist()
            for seq, rel_len in zip(batch, lengths)]


def round_up(value, multiple):
    """Smallest multiple of ``multiple`` that is >= ``value``."""
    return int(-(-value // multiple) * multiple)


def pad_time_to_multiple(x, lengths=None, multiple=128, value=0.0):
    """Pad the time axis (axis 1) of a (B, T, ...) tensor to a multiple
    and rescale relative lengths to the new T.

    Example
    -------
    >>> import torch
    >>> x, lens = pad_time_to_multiple(torch.ones(2, 251, 4),
    ...                                torch.ones(2), multiple=128)
    >>> x.shape[1], float(lens[0])
    (256, 0.98046875)
    """
    T = x.shape[1]
    pad = (-T) % multiple
    if pad == 0:
        return x, lengths
    pads = [0, 0] * (x.ndim - 2) + [0, pad]
    x = F.pad(x, pads, value=value)
    if lengths is not None:
        lengths = lengths * (T / (T + pad))
    return x, lengths


def split_path(path):
    """``(source, filename)`` of a path or URI: split at its last ``/``,
    a bare name lying in ``./``.

    Example
    -------
    >>> split_path("models/asr/encoder.ckpt")
    ('models/asr', 'encoder.ckpt')
    >>> split_path("encoder.ckpt")
    ('./', 'encoder.ckpt')
    """
    path = str(path)
    if "/" in path:
        source, filename = path.rsplit("/", maxsplit=1)
    else:
        source, filename = "./", path
    return source, filename
