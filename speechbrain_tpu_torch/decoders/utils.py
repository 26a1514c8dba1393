"""Decoder helpers (port of ``speechbrain_tpu/decoders/utils.py``:
``inflate_tensor``, ``mask_by_condition``, ``update_mem``; plus the top-k
the searchers share)."""

import torch


def inflate_tensor(tensor, times, dim):
    """Repeat each entry ``times`` along ``dim`` (beam inflation).

    Example
    -------
    >>> inflate_tensor(torch.tensor([[1, 2]]), 2, dim=0).tolist()
    [[1, 2], [1, 2]]
    """
    return torch.repeat_interleave(tensor, times, dim=dim)


def mask_by_condition(tensor, cond, fill_value):
    """``tensor`` where ``cond`` holds, ``fill_value`` elsewhere.

    Example
    -------
    >>> mask_by_condition(torch.tensor([1.0, 2.0]),
    ...                   torch.tensor([True, False]), 0.0).tolist()
    [1.0, 0.0]
    """
    return torch.where(cond, tensor, fill_value)


def update_mem(inp_tokens, memory):
    """Append the (B,) token column ``inp_tokens`` to a growing (B, t)
    memory; ``None`` starts one.

    Example
    -------
    >>> update_mem(torch.tensor([3, 4]), torch.tensor([[1], [2]])).tolist()
    [[1, 3], [2, 4]]
    """
    if memory is None:
        return inp_tokens[:, None]
    return torch.cat([memory, inp_tokens[:, None]], dim=-1)


def top_k_lowest_index(x, k):
    """Top ``k`` along the last axis, sorted by descending value, taking
    the LOWEST index among equal values, as ``jax.lax.top_k`` does.

    ``torch.topk`` leaves the order of ties open. Beam search depends on
    it: dead beams and unscored tokens sit at exactly equal large negative
    scores, and which of them fills a beam slot decides the tokens that
    follow. A stable descending sort keeps equal values in index order.
    """
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
