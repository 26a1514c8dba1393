"""Beam-search predecessor gathers (port of
``speechbrain_tpu/decoders/permute.py``).

The JAX package expresses these gathers as block-diagonal one-hot matrix
products because row gathers are slow on its hardware; the semantics are
those of ``index_select`` along axis 0, which is what runs here.
"""

import torch


def gather_rows(t, index):
    """Gather rows of ``t`` along axis 0 by ``index`` (flat batch*beam
    predecessor indices); non-tensor leaves and 0-d tensors are returned
    unchanged."""
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        return t
    return t.index_select(0, index)


def gather_tree(tree, index):
    """``gather_rows`` over every tensor leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, index) for v in tree)
    return gather_rows(tree, index)
