"""Row gather ``x[idx]`` along axis 0 (port of
``speechbrain_tpu/ops/gather.py``).

Written for the predecessor permute of beam-search KV caches: after each
decode step every per-hypothesis buffer ``(batch*beam, L, D)`` is replaced
by its rows in predecessor order, megabytes a buffer. The copy is a
hand-written CUDA kernel (``csrc/row_gather.cu``) that moves each row as
16-byte vectors; ``row_gather_reference`` (``index_select``) is the plain
PyTorch version of the same function, and the wrapper takes it only for
tensors that lie on the CPU.

Unlike the JAX package's dispatcher there is no size threshold and no
fallback: on a CUDA tensor the kernel runs or the call raises.
"""

import math

import torch

from speechbrain_tpu_torch.ops import refuse_autograd
from speechbrain_tpu_torch.ops._build import load_library

# number of kernel launches made by this process (the plain version does
# not count); ``chip_smoke.py`` zeroes and reads it
launches = 0

_INDEX_DTYPES = (torch.int32, torch.int64)


def row_gather_reference(x, idx):
    """Plain PyTorch version: ``x.index_select(0, idx)``.

    Arguments
    ---------
    x : (N, ...) tensor of any dtype.
    idx : (n_out,) int32 or int64 indices in [0, N).

    Returns
    -------
    (n_out, ...) tensor, a new one (not a view of ``x``).
    """
    return x.index_select(0, idx)


def _row_gather_cuda(x, idx):
    """Launch ``csrc/row_gather.cu`` on PyTorch's current stream."""
    global launches
    refuse_autograd("row_gather_reference", x)
    if not x.is_cuda or not idx.is_cuda:
        raise ValueError("x and idx must both be CUDA tensors")
    if x.device != idx.device:
        raise ValueError("x and idx must lie on the same device")
    if x.ndim < 1:
        raise ValueError("x must have an axis 0 to gather along")
    if idx.ndim != 1:
        raise ValueError(f"idx must be 1-D, not {idx.ndim}-D")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"idx must be int32 or int64, not {idx.dtype}")
    if not x.is_contiguous() or not idx.is_contiguous():
        raise ValueError("x and idx must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    n_out, n_src = idx.shape[0], x.shape[0]
    if n_out and not n_src:
        raise ValueError("cannot gather rows from an x with none")
    out = torch.empty((n_out,) + tuple(x.shape[1:]), device=x.device,
                      dtype=x.dtype)
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    if out.numel() == 0:
        return out  # nothing to copy: no launch
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.sb_row_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_out, n_src,
            row_bytes, int(idx.dtype == torch.int64),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row gather kernel launch failed (code {err})")
    launches += 1
    return out


def row_gather(x, idx):
    """Gather rows of ``x`` (axis 0) by the 1-D int32/int64 ``idx``.

    A CUDA tensor goes to the hand-written kernel, or the call raises; a
    CPU tensor goes to :func:`row_gather_reference`. Indices must lie in
    ``[0, x.shape[0])``: the kernel writes a row of zero bytes for one that
    does not, and never reads outside ``x``; the plain version raises.

    Example
    -------
    >>> x = torch.arange(12.0).reshape(3, 4)
    >>> row_gather(x, torch.tensor([2, 0]))[:, 0].tolist()
    [8.0, 0.0]
    """
    if x.is_cuda:
        return _row_gather_cuda(x, idx)
    return row_gather_reference(x, idx)


def gather_pytree(tree, idx, rows=row_gather):
    """``rows(leaf, idx)`` (by default :func:`row_gather`) over every tensor
    leaf of nested dicts, lists and tuples; non-tensor leaves and 0-d
    tensors are returned unchanged."""
    if isinstance(tree, dict):
        return {k: gather_pytree(v, idx, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_pytree(v, idx, rows) for v in tree)
    if not isinstance(tree, torch.Tensor) or tree.ndim == 0:
        return tree
    return rows(tree, idx)
