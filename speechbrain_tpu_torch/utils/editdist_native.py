"""ctypes binding of the native edit-distance core (port of
``speechbrain_tpu/utils/editdist_native.py``).

``_editdist.cpp`` is built with ``g++`` at first use into
``speechbrain_tpu_torch/_build/`` (``utils/host_build.py``). A call
releases the GIL and shards the batch over the host's hardware threads. A
failed build or load raises; there is no switch to another path.
"""

import ctypes
import functools
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.utils.host_build import load_host_library

SOURCE = Path(__file__).resolve().parent / "_editdist.cpp"


@functools.lru_cache(maxsize=None)
def load_library():
    """The core as a ``ctypes.CDLL`` (built on first call)."""
    lib = load_host_library(SOURCE)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.sb_edit_ops_batch.argtypes = [i32, i64, i32, i64, ctypes.c_int64,
                                      i32]
    lib.sb_edit_ops_batch.restype = None
    return lib


def _flatten(seqs, token_to_id):
    flat, offsets = [], [0]
    for seq in seqs:
        flat.extend(token_to_id[t] for t in seq)
        offsets.append(len(flat))
    return np.asarray(flat, np.int32), np.asarray(offsets, np.int64)


def edit_ops_batch(refs, hyps):
    """(insertions, deletions, substitutions) of each (ref, hyp) pair as
    an (n, 3) int32 array, with the Python DP's tie order (substitution,
    then insertion, then deletion). Tokens may be any hashable values.

    Example
    -------
    >>> edit_ops_batch([["a", "b", "c"]], [["a", "x"]]).tolist()
    [[0, 1, 1]]
    """
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references for {len(hyps)} hypotheses")
    token_to_id = {}
    for seqs in (refs, hyps):
        for seq in seqs:
            for t in seq:
                token_to_id.setdefault(t, len(token_to_id))
    a, a_off = _flatten(refs, token_to_id)
    b, b_off = _flatten(hyps, token_to_id)
    out = np.zeros((len(refs), 3), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    load_library().sb_edit_ops_batch(
        a.ctypes.data_as(i32), a_off.ctypes.data_as(i64),
        b.ctypes.data_as(i32), b_off.ctypes.data_as(i64),
        len(refs), out.ctypes.data_as(i32),
    )
    return out
