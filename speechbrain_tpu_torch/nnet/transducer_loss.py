"""RNN-T (transducer) loss (port of
``speechbrain_tpu/nnet/transducer_loss.py``), in plain PyTorch.

The forward variable alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
alpha(t, u-1) + label(t, u-1)) goes row by row over t. Within a row the
recurrence over u, x_u = logaddexp(B_u, A_u + x_{u-1}), is a first-order
recurrence in the log semiring, solved as the JAX package solves it, by a
scan with the same ``combine``: here a Hillis-Steele doubling, ceil(log2(U+1))
steps over the whole batch. Autograd gives the gradient, as XLA's autodiff
does in JAX.

Log-zero is ``NEG_INF = -1e30``, not ``-inf``: ``logaddexp(-inf, -inf)``
has a NaN gradient, and the masked label transitions past a target's length
and the first row both reach it. The closed form of the recurrence (a
cumulative sum of A, then a ``logcumsumexp``) is not used: with A_0 = -1e30
it cancels catastrophically in float32.
"""

import torch

NEG_INF = -1e30


def _log_affine_scan(A, B):
    """Solve x_u = logaddexp(B_u, A_u + x_{u-1}) for every u, with
    x_{-1} = log 0 (so x_0 = B_0): an inclusive scan of (A, B) pairs under
    ``combine((A1, B1), (A2, B2)) = (A1 + A2, logaddexp(B2, A2 + B1))``,
    by doubling over the last axis. A, B: (..., U)."""
    n = A.shape[-1]
    shift = 1
    while shift < n:
        A_left, B_left = A[..., :-shift], B[..., :-shift]
        A_right, B_right = A[..., shift:], B[..., shift:]
        B = torch.cat([B[..., :shift],
                       torch.logaddexp(B_right, A_right + B_left)], dim=-1)
        A = torch.cat([A[..., :shift], A_left + A_right], dim=-1)
        shift *= 2
    return B


def transducer_loss(log_probs, targets, input_lens, target_lens, blank_index,
                    reduction="mean"):
    """Negative log-likelihood of the RNN-T alignment lattice.

    Arguments
    ---------
    log_probs : (B, T, U+1, V) joint-network log-probabilities.
    targets : (B, U) integer labels.
    input_lens, target_lens : (B,) relative lengths in [0, 1]; the absolute
        ones are ``round(lens * T)`` and ``round(lens * U)``.
    blank_index : int
    reduction : ``"mean"`` (the mean of each row's loss over its target
        length, at least 1), ``"batchmean"``, ``"sum"``; anything else
        returns the (B,) rows.

    Example
    -------
    >>> lp = torch.log_softmax(torch.zeros(1, 3, 3, 4), -1)
    >>> t = torch.tensor([[1, 2]])
    >>> float(transducer_loss(lp, t, torch.ones(1), torch.ones(1), 0)) > 0
    True
    """
    B, T, U1, _ = log_probs.shape
    device = log_probs.device
    T_abs = torch.round(input_lens * T).to(torch.long)
    U_abs = torch.round(target_lens * targets.shape[1]).to(torch.long)

    blank_lp = log_probs[..., blank_index]  # (B, T, U+1)
    # the label transition u -> u+1 reads target[u]; the last column is
    # unused
    tgt_idx = torch.cat([targets.to(torch.long),
                         targets.new_zeros((B, 1), dtype=torch.long)], dim=1)
    label_lp = torch.gather(
        log_probs, 3, tgt_idx[:, None, :, None].expand(B, T, U1, 1)
    )[..., 0]  # (B, T, U+1)
    u_range = torch.arange(U1, device=device)
    label_valid = u_range[None, :] < U_abs[:, None]  # (B, U+1)
    label_lp = torch.where(label_valid[:, None, :], label_lp,
                           torch.full_like(label_lp, NEG_INF))
    # A_u = label(t, u-1), with A_0 = log 0
    A_all = torch.cat([label_lp.new_full((B, T, 1), NEG_INF),
                       label_lp[:, :, :-1]], dim=2)

    # t = 0: alpha(0, 0) = 0, alpha(0, u) the labels up to u at t = 0
    base0 = label_lp.new_full((B, U1), NEG_INF)
    base0[:, 0] = 0.0
    alphas = [_log_affine_scan(A_all[:, 0], base0)]
    for t in range(1, T):
        base = alphas[-1] + blank_lp[:, t - 1]
        alphas.append(_log_affine_scan(A_all[:, t], base))
    all_alphas = torch.stack(alphas, dim=1)  # (B, T, U+1)

    # alpha(T-1, U) + blank(T-1, U), at each row's lengths
    b_idx = torch.arange(B, device=device)
    t_last = torch.clamp(T_abs - 1, min=0)
    log_like = (all_alphas[b_idx, t_last, U_abs]
                + blank_lp[b_idx, t_last, U_abs])
    loss = -log_like
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(U_abs, min=1))
    if reduction == "batchmean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


class TransducerLoss(torch.nn.Module):
    """Module form of :func:`transducer_loss` (the reference's
    ``Transducer`` loss module).

    Example
    -------
    >>> loss = TransducerLoss(blank_index=0)
    >>> lp = torch.log_softmax(torch.zeros(1, 3, 3, 4), -1)
    >>> float(loss(lp, torch.tensor([[1, 2]]), torch.ones(1),
    ...            torch.ones(1))) > 0
    True
    """

    def __init__(self, blank_index=0, reduction="mean"):
        super().__init__()
        self.blank_index = blank_index
        self.reduction = reduction

    def forward(self, log_probs, targets, input_lens, target_lens):
        return transducer_loss(log_probs, targets, input_lens, target_lens,
                               self.blank_index, self.reduction)
