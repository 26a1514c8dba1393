"""Beam-search predecessor gathers (port of
``speechbrain_tpu/decoders/permute.py``).

The JAX package expresses these gathers as block-diagonal one-hot matrix
products because row gathers are slow on its hardware; the semantics are
those of ``index_select`` along axis 0, which is what runs here. The
per-step K/V buffers of the permuting search go through the row-gather
kernel instead (``ops.gather.gather_pytree``).
"""

from speechbrain_tpu_torch.ops.gather import (
    gather_pytree,
    row_gather_reference,
)


def gather_tree(tree, index):
    """``index_select`` along axis 0 by ``index`` (flat batch*beam
    predecessor indices) over every tensor leaf of nested dicts/lists;
    non-tensor leaves and 0-d tensors are returned unchanged."""
    return gather_pytree(tree, index, rows=row_gather_reference)
