"""Losses masked by relative lengths (port of the sequence losses of
``speechbrain_tpu/nnet/losses.py``: ``compute_length_mask``,
``compute_masked_loss``, ``nll_loss``, ``kldiv_loss``, ``ctc_loss``).

Conventions as in the JAX package: predictions (batch, time, ...) with
*relative* lengths in [0, 1], turned into counts by ``round(len * T)``
(half to even, as ``jnp.round``); reduction in {"mean", "batchmean",
"batch", "sum", None}. Every function computes on its inputs' device.
"""

import torch
import torch.nn.functional as F


def compute_length_mask(data, length=None, len_dim=1):
    """Boolean mask of ``data``'s shape, True where the position along
    ``len_dim`` lies inside ``round(length * T)``.

    Example
    -------
    >>> compute_length_mask(torch.zeros(2, 4), torch.tensor([0.5, 1.0]))
    tensor([[ True,  True, False, False],
            [ True,  True,  True,  True]])
    """
    if length is None:
        return torch.ones_like(data, dtype=torch.bool)
    T = data.shape[len_dim]
    valid = torch.round(length * T).to(torch.int32)
    shape = [1] * data.ndim
    shape[len_dim] = T
    idx = torch.arange(T, device=data.device).reshape(shape)
    vshape = [1] * data.ndim
    vshape[0] = data.shape[0]
    return (idx < valid.reshape(vshape)).expand(data.shape)


def _reduce(loss, mask, reduction):
    mask = mask.to(loss.dtype)
    loss = loss * mask
    if reduction == "mean":
        return loss.sum() / mask.sum().clamp(min=1.0)
    if reduction == "batchmean":
        return loss.sum() / loss.shape[0]
    if reduction == "batch":
        axes = tuple(range(1, loss.ndim))
        return loss.sum(dim=axes) / mask.sum(dim=axes).clamp(min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def compute_masked_loss(loss_fn, predictions, targets, length=None,
                        mask=None, reduction="mean"):
    """Apply an elementwise ``loss_fn(predictions, targets)`` with length
    masking."""
    if mask is None:
        mask = compute_length_mask(targets, length)
    return _reduce(loss_fn(predictions, targets), mask, reduction)


def _smoothed_nll(log_probabilities, targets, label_smoothing):
    picked = torch.gather(
        log_probabilities, -1, targets.unsqueeze(-1)
    ).squeeze(-1)
    loss = -picked
    if label_smoothing > 0:
        smooth = -log_probabilities.mean(dim=-1)
        loss = (1 - label_smoothing) * loss + label_smoothing * smooth
    return loss


def nll_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
             allowed_len_diff=3, reduction="mean"):
    """Negative log-likelihood of (batch, [time,] classes) log-probs.

    Example
    -------
    >>> logp = torch.log(torch.tensor([[0.9, 0.1], [0.1, 0.9]]))
    >>> float(nll_loss(logp, torch.tensor([0, 1]))) < 0.2
    True
    """
    targets = targets.long()
    loss = _smoothed_nll(log_probabilities, targets, label_smoothing)
    if log_probabilities.ndim == 3:
        return _reduce(loss, compute_length_mask(loss, length), reduction)
    return _reduce(loss, torch.ones_like(loss, dtype=torch.bool), reduction)


def kldiv_loss(log_probabilities, targets, length=None, label_smoothing=0.0,
               allowed_len_diff=3, pad_idx=0, reduction="mean"):
    """Label-smoothed KL-divergence loss, the seq2seq objective: the
    smoothed target is (1 - a)·one_hot + a·uniform. Targets equal to
    ``pad_idx`` are masked besides the lengths; ``"batchmean"`` divides by
    the count of unmasked tokens. Without smoothing it is ``nll_loss``."""
    targets = targets.long()
    if label_smoothing <= 0:
        return nll_loss(log_probabilities, targets, length, 0.0,
                        allowed_len_diff, reduction)
    K = log_probabilities.shape[-1]
    confidence = 1.0 - label_smoothing
    true_ll = torch.gather(
        log_probabilities, -1, targets.unsqueeze(-1)
    ).squeeze(-1)
    uniform_ll = log_probabilities.sum(dim=-1) / K
    loss = -(confidence * true_ll + label_smoothing * uniform_ll)
    mask = compute_length_mask(loss, length)
    if pad_idx is not None:
        mask = mask & (targets != pad_idx)
    if reduction == "batchmean":
        m = mask.to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp(min=1.0)
    return _reduce(loss, mask, reduction)


def ctc_loss(log_probs, targets, input_lens, target_lens, blank_index,
             reduction="mean"):
    """CTC loss of (batch, time, classes) log-probs with *relative* input
    and target lengths, through ``torch.nn.functional.ctc_loss``.
    ``"mean"`` divides each sequence's loss by its target length, then
    averages over the batch.

    An alignment that cannot be made (a target longer than its input
    allows) gives ``inf``, where the JAX package's optax gives about 1e5.

    Example
    -------
    >>> logp = torch.log_softmax(torch.zeros(1, 4, 3), dim=-1)
    >>> loss = ctc_loss(logp, torch.tensor([[1, 2]]), torch.tensor([1.0]),
    ...                 torch.tensor([1.0]), blank_index=0)
    >>> bool(loss > 0)
    True
    """
    B, T, _ = log_probs.shape
    N = targets.shape[1]
    in_abs = torch.round(input_lens * T).long()
    tgt_abs = torch.round(target_lens * N).long()
    per_seq = F.ctc_loss(
        log_probs.transpose(0, 1), targets.long(), in_abs, tgt_abs,
        blank=blank_index, reduction="none", zero_infinity=False,
    )
    if reduction == "mean":
        return (per_seq / tgt_abs.clamp(min=1).to(per_seq.dtype)).mean()
    if reduction == "batchmean":
        return per_seq.mean()
    if reduction == "sum":
        return per_seq.sum()
    return per_seq
