"""Streaming helpers (port of ``speechbrain_tpu/utils/streaming.py``):
fixed-size chunks of an array or tensor, the relative lengths of each
chunk, and the spans of a boolean activity mask.
"""

import numpy as np


def split_fixed_chunks(x, chunk_size, axis=-1):
    """Split ``x`` (a numpy array or a tensor) along ``axis`` into chunks
    of ``chunk_size``; the last may be shorter. The chunks are views.

    Example
    -------
    >>> chunks = split_fixed_chunks(np.zeros((2, 100)), 30)
    >>> [c.shape[-1] for c in chunks]
    [30, 30, 30, 10]
    """
    length = x.shape[axis]
    n = -(-length // chunk_size)
    out = []
    for i in range(n):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i * chunk_size, min((i + 1) * chunk_size, length))
        out.append(x[tuple(sl)])
    return out


def split_wav_lens(chunk_lens, wav_lens):
    """Each chunk's relative lengths, given the chunks' lengths and the
    utterances' relative lengths over their concatenation.

    Example
    -------
    >>> lens = split_wav_lens([30, 30, 10], np.asarray([1.0, 0.5]))
    >>> [[round(float(v), 2) for v in l] for l in lens]
    [[1.0, 1.0], [1.0, 0.17], [1.0, 0.0]]
    """
    wav_lens = np.asarray(wav_lens, np.float32)
    total = float(sum(chunk_lens))
    out = []
    consumed = 0.0
    for clen in chunk_lens:
        abs_lens = wav_lens * total
        chunk_abs = np.clip(abs_lens - consumed, 0.0, clen)
        out.append(chunk_abs / clen)
        consumed += clen
    return out


def boolean_mask_to_chunks(mask):
    """``[start, end)`` index pairs of the runs of True in ``mask``.

    Example
    -------
    >>> boolean_mask_to_chunks([0, 1, 1, 0, 1])
    [(1, 3), (4, 5)]
    """
    mask = np.asarray(mask).astype(int)
    diff = np.diff(np.concatenate([[0], mask, [0]]))
    starts = np.where(diff == 1)[0]
    ends = np.where(diff == -1)[0]
    return list(zip(starts.tolist(), ends.tolist()))
