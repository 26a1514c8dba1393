"""Losses masked by relative lengths (port of the sequence losses of
``speechbrain_tpu/nnet/losses.py``: ``compute_length_mask``,
``compute_masked_loss``, ``nll_loss``, ``kldiv_loss``, ``ctc_loss``,
``classification_error``, the regression losses ``mse_loss`` and
``l1_loss``, the frame classifiers' ``bce_loss``, the speaker family's margins
``AngularMargin``, ``AdditiveAngularMargin`` and ``LogSoftmaxWrapper``,
and the separation objectives ``cal_si_snr``, ``cal_snr``,
``PitWrapper`` and ``get_si_snr_with_pitwrapper``, and wav2vec 2.0's
``contrastive_loss``).

Conventions as in the JAX package: predictions (batch, time, ...) with
*relative* lengths in [0, 1], turned into counts by ``round(len * T)``
(half to even, as ``jnp.round``); reduction in {"mean", "batchmean",
"batch", "sum", None}. Every function computes on its inputs' device.
"""

import itertools
import math

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


def mse_loss(predictions, targets, length=None, reduction="mean"):
    """Squared error masked by relative lengths along axis 1.

    Example
    -------
    >>> float(mse_loss(torch.ones(2, 4), torch.zeros(2, 4),
    ...                torch.tensor([0.5, 1.0]), reduction="sum"))
    6.0
    """
    return compute_masked_loss(lambda p, t: (p - t) ** 2, predictions,
                               targets, length, reduction=reduction)


def l1_loss(predictions, targets, length=None, reduction="mean"):
    """Absolute error masked by relative lengths along axis 1."""
    return compute_masked_loss(lambda p, t: torch.abs(p - t), predictions,
                               targets, length, reduction=reduction)


def bce_loss(inputs, targets, length=None, weight=None, pos_weight=None,
             reduction="mean", allowed_len_diff=3, label_smoothing=0.0):
    """Binary cross-entropy on logits, masked by relative lengths along
    axis 1: ``-(w_pos t log s(x) + (1 - t) log s(-x)) w`` with the
    targets smoothed towards 0.5 by ``label_smoothing``; ``weight`` and
    ``pos_weight`` broadcast against the logits.

    Example
    -------
    >>> float(bce_loss(torch.zeros(1, 2), torch.ones(1, 2)))  # log 2
    0.6931471824645996
    """
    targets = targets.to(inputs.dtype)
    if label_smoothing > 0:
        targets = targets * (1 - label_smoothing) + 0.5 * label_smoothing

    def fn(logits, t):
        logp = F.logsigmoid(logits)
        lognotp = F.logsigmoid(-logits)
        pos = t * logp if pos_weight is None else pos_weight * t * logp
        loss = -(pos + (1 - t) * lognotp)
        return loss if weight is None else loss * weight

    return compute_masked_loss(fn, inputs, targets, length,
                               reduction=reduction)


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


def classification_error(probabilities, targets, length=None,
                         allowed_len_diff=3, reduction="mean"):
    """1 - accuracy of the argmax over the last axis: over (batch, time,
    classes) with (batch, time) targets masked by ``length``, otherwise
    over every row.

    Example
    -------
    >>> probs = torch.tensor([[0.9, 0.1], [0.2, 0.8]])
    >>> float(classification_error(probs, torch.tensor([0, 0])))
    0.5
    """
    err = (probabilities.argmax(dim=-1) != targets).to(torch.float32)
    if probabilities.ndim == 3 and targets.ndim == 2:
        return _reduce(err, compute_length_mask(err, length), reduction)
    return _reduce(err, torch.ones_like(err, dtype=torch.bool), reduction)


def cal_si_snr(source, estimate_source, lengths=None, eps=1e-8):
    """Scale-invariant SNR in dB of each source, (batch, n_src), from
    (batch, time, n_src) targets and estimates. With relative ``lengths``
    the samples past ``round(lengths * T)`` (half to even, as
    ``jnp.round``) are zeroed and the means taken over the rest.

    Example
    -------
    >>> s = torch.sin(torch.arange(100.0))[None, :, None]
    >>> cal_si_snr(s, 2 * s + 0.1 * s.flip(1)).shape
    torch.Size([1, 1])
    """
    if lengths is not None:
        T = source.shape[1]
        n = torch.round(lengths * T)
        mask = (torch.arange(T, device=source.device)[None, :, None]
                < n[:, None, None]).to(source.dtype)
        source = source * mask
        estimate_source = estimate_source * mask
        denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    else:
        denom = source.shape[1]
    s = source - source.sum(1, keepdim=True) / denom
    e = estimate_source - estimate_source.sum(1, keepdim=True) / denom
    if lengths is not None:
        s = s * mask
        e = e * mask
    dot = (e * s).sum(1, keepdim=True)
    s_energy = (s ** 2).sum(1, keepdim=True) + eps
    proj = dot * s / s_energy
    noise = e - proj
    ratio = (proj ** 2).sum(1) / ((noise ** 2).sum(1) + eps)
    return 10 * torch.log10(ratio + eps)


def cal_snr(source, estimate_source, eps=1e-8):
    """Plain SNR in dB of each source, (batch, n_src), from (batch, time,
    n_src) targets and estimates."""
    noise = estimate_source - source
    ratio = (source ** 2).sum(1) / ((noise ** 2).sum(1) + eps)
    return 10 * torch.log10(ratio + eps)


class PitWrapper:
    """Permutation-invariant training: ``base_loss(targets, permuted)``,
    (batch, n_src) or (batch,), under every permutation of the estimates'
    sources (the last axis), and for each utterance the least of them.
    Returns ``(loss (batch,), chosen permutations (batch, n_src))``; of
    tied permutations the first, in ``itertools.permutations`` order.

    Example
    -------
    >>> pit = PitWrapper(lambda t, e: ((t - e) ** 2).mean(1))
    >>> t = torch.tensor([[[1.0, 0.0], [1.0, 0.0]]])
    >>> loss, perms = pit(t.flip(-1), t)
    >>> float(loss[0]), perms.tolist()
    (0.0, [[1, 0]])
    """

    def __init__(self, base_loss):
        self.base_loss = base_loss

    def __call__(self, preds, targets):
        n_src = targets.shape[-1]
        perms = torch.tensor(list(itertools.permutations(range(n_src))),
                             device=preds.device)
        losses = []
        for perm in perms:
            loss = self.base_loss(targets, preds[..., perm])
            if loss.ndim == 2:
                loss = loss.mean(-1)
            losses.append(loss)
        stacked = torch.stack(losses, dim=1)  # (batch, n_perms)
        best = stacked.argmin(dim=1)  # the first of tied minima
        loss = stacked.gather(1, best[:, None])[:, 0]
        return loss, perms[best]

    def reorder_tensor(self, tensor, p):
        """``tensor[b, ..., p[b]]`` for each utterance ``b``: its sources
        in the chosen order."""
        index = p.reshape(p.shape[0], *([1] * (tensor.ndim - 2)),
                          p.shape[1]).expand(*tensor.shape[:-1], p.shape[1])
        return torch.gather(tensor, -1, index)


def get_si_snr_with_pitwrapper(source, estimate_source, lengths=None):
    """The negated PIT SI-SNR of each utterance, (batch,): the SepFormer
    objective, from (batch, time, n_src) targets and estimates."""
    pit = PitWrapper(lambda t, e: -cal_si_snr(t, e, lengths=lengths))
    loss, _ = pit(estimate_source, source)
    return loss


class AngularMargin:
    """``scale * (outputs - margin * targets)`` over cosine similarities
    and one-hot targets.

    Example
    -------
    >>> am = AngularMargin(margin=0.2, scale=30)
    >>> am(torch.tensor([[0.9, 0.1]]), torch.tensor([[1.0, 0.0]]))
    tensor([[21.,  3.]])
    """

    def __init__(self, margin=0.0, scale=1.0):
        self.margin = margin
        self.scale = scale

    def __call__(self, outputs, targets):
        return self.scale * (outputs - self.margin * targets)


class AdditiveAngularMargin(AngularMargin):
    """ArcFace's additive angular margin (AAM-softmax), the ECAPA
    speaker loss: the target class's cosine becomes cos(theta + margin),
    taken as ``cos - mm`` where theta + margin would pass pi (``easy``:
    where the cosine is not positive). Cosines are clipped to
    +-(1 - 1e-7) first. Computes in float32 whatever the input's type.

    Example
    -------
    >>> aam = AdditiveAngularMargin(margin=0.2, scale=30)
    >>> aam(torch.tensor([[0.9, 0.1]]), torch.tensor([[1.0, 0.0]])).shape
    torch.Size([1, 2])
    """

    def __init__(self, margin=0.0, scale=1.0, easy_margin=False):
        super().__init__(margin, scale)
        self.easy_margin = easy_margin
        self.cos_m = math.cos(margin)
        self.sin_m = math.sin(margin)
        self.th = math.cos(math.pi - margin)
        self.mm = math.sin(math.pi - margin) * margin

    def __call__(self, outputs, targets):
        cosine = outputs.float().clamp(-1 + 1e-7, 1 - 1e-7)
        sine = torch.sqrt(1.0 - cosine**2)
        phi = cosine * self.cos_m - sine * self.sin_m
        if self.easy_margin:
            phi = torch.where(cosine > 0, phi, cosine)
        else:
            phi = torch.where(cosine > self.th, phi, cosine - self.mm)
        targets = targets.float()
        return self.scale * (targets * phi + (1.0 - targets) * cosine)


class LogSoftmaxWrapper:
    """Cross-entropy over ``loss_fn(outputs, one_hot(targets))`` (a
    margin such as :class:`AdditiveAngularMargin`), averaged over the
    batch. ``outputs`` are (B, C) or (B, 1, C); a ``loss_fn`` that takes
    no targets (it raises ``TypeError`` given two arguments) is called
    with the outputs alone. ``length`` is accepted and unread.

    Example
    -------
    >>> loss = LogSoftmaxWrapper(AdditiveAngularMargin(0.2, 30))
    >>> cos = torch.tensor([[0.9, 0.1], [0.1, 0.9]])
    >>> float(loss(cos, torch.tensor([0, 1]))) < 1.0
    True
    """

    def __init__(self, loss_fn):
        self.loss_fn = loss_fn

    def __call__(self, outputs, targets, length=None):
        if outputs.ndim == 3:
            outputs = outputs[:, 0, :]
        targets = targets.reshape(-1).long()
        onehot = F.one_hot(targets, outputs.shape[-1]).to(outputs.dtype)
        try:
            predictions = self.loss_fn(outputs, onehot)
        except TypeError:
            predictions = self.loss_fn(outputs)
        logp = torch.log_softmax(predictions.float(), dim=-1)
        return -(logp * onehot.float()).sum(dim=-1).mean()


# optax.ctc_loss's stand-in for log(0) (its ``log_epsilon`` default)
CTC_LOG_EPSILON = -1e5


def ctc_loss(log_probs, targets, input_lens, target_lens, blank_index,
             reduction="mean"):
    """CTC loss of (batch, time, classes) log-probs with *relative* input
    and target lengths. ``"mean"`` divides each sequence's loss by its
    target length, then averages over the batch.

    Rows that can be aligned go through ``torch.nn.functional.ctc_loss``.
    A row that cannot (fewer frames than targets plus their adjacent
    repeats) has no path, and ``F.ctc_loss`` would give ``inf``; such rows
    go through :func:`ctc_loss_log_epsilon`, optax's recursion with log(0)
    taken as -1e5, and give the large finite value and the gradient that
    the JAX package's optax gives. Finding those rows reads a (B,) mask on
    the host: one sync a call.

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
    targets = targets.long()
    in_abs = torch.round(input_lens * T).long()
    tgt_abs = torch.round(target_lens * N).long()
    # frames a path needs: one a label, one more between equal neighbours
    inside = (torch.arange(N - 1, device=targets.device)[None, :]
              < tgt_abs[:, None] - 1)
    repeats = ((targets[:, 1:] == targets[:, :-1]) & inside).sum(dim=1)
    infeasible = in_abs < tgt_abs + repeats
    per_seq = F.ctc_loss(
        log_probs.transpose(0, 1), targets, in_abs, tgt_abs,
        blank=blank_index, reduction="none", zero_infinity=True,
    )
    if bool(infeasible.any()):
        rows = infeasible.nonzero().squeeze(1)
        twin = ctc_loss_log_epsilon(
            log_probs[rows], targets[rows], in_abs[rows], tgt_abs[rows],
            blank_index,
        )
        per_seq = per_seq.index_put((rows,), twin.to(per_seq.dtype))
    if reduction == "mean":
        return (per_seq / tgt_abs.clamp(min=1).to(per_seq.dtype)).mean()
    if reduction == "batchmean":
        return per_seq.mean()
    if reduction == "sum":
        return per_seq.sum()
    return per_seq


def ctc_loss_log_epsilon(logits, targets, in_abs, tgt_abs, blank_index):
    """Per-sequence CTC loss by ``optax.ctc_loss``'s recursion in plain
    torch: log-softmax of ``logits`` (B, T, K), then a scan over the
    frames of the blank and label forward variables with log(0) taken as
    ``CTC_LOG_EPSILON``; a frame at or past ``in_abs`` leaves the state as it
    is; the loss is read at ``tgt_abs``. Repeats are taken between
    neighbours of the whole padded ``targets`` row, as optax takes them.
    Autograd gives the gradient. A step a frame: meant for the few rows
    ``F.ctc_loss`` cannot align, not for the training path."""
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    B, T, _ = logp.shape
    N = targets.shape[1]
    kw = dict(device=logp.device, dtype=logp.dtype)
    repeat = torch.zeros(B, N, **kw)
    repeat[:, :-1] = targets[:, :-1] == targets[:, 1:]
    lp_blank = logp[:, :, blank_index:blank_index + 1]  # (B, T, 1)
    lp_emit = torch.gather(logp, 2, targets[:, None, :].expand(B, T, N))
    pad = (torch.arange(T, device=logp.device)[None, :, None]
           >= in_abs[:, None, None]).to(logp.dtype)  # (B, T, 1)
    phi = torch.full((B, N + 1), CTC_LOG_EPSILON, **kw)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), CTC_LOG_EPSILON, **kw)

    def add_to_tail(p, added):
        return torch.cat([p[:, :1], _LogAddExp.apply(p[:, 1:], added)], dim=1)

    for t in range(T):
        phi_orig = phi
        # label -> blank state with no frame, unless the next label repeats
        phi = add_to_tail(phi, emit + CTC_LOG_EPSILON * repeat)
        next_emit = _LogAddExp.apply(phi[:, :-1] + lp_emit[:, t],
                                    emit + lp_emit[:, t])
        next_phi = add_to_tail(
            phi + lp_blank[:, t],
            emit + lp_blank[:, t] + CTC_LOG_EPSILON * (1.0 - repeat),
        )
        emit = pad[:, t] * emit + (1.0 - pad[:, t]) * next_emit
        phi = pad[:, t] * phi_orig + (1.0 - pad[:, t]) * next_phi
    phi = add_to_tail(phi, emit)
    return -torch.gather(phi, 1, tgt_abs[:, None]).squeeze(1)


class _LogAddExp(torch.autograd.Function):
    """``logaddexp`` with ``jnp.logaddexp``'s arithmetic: max + log1p(exp(
    -|a - b|)) forward; backward g·exp(a - out) and g·exp(b - out). Next to
    log(0) taken as -1e5 the operands are about 1e5 apart, where float32
    keeps 2-3 decimals of their difference: torch's own backward,
    g / (1 + exp(b - a)), rounds otherwise and drifts from optax's
    gradient by about 1 %."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, out = ctx.saved_tensors
        return grad * torch.exp(a - out), grad * torch.exp(b - out)


def contrastive_loss(pos_sim, neg_sim, temperature=0.1):
    """InfoNCE from similarities: ``pos_sim`` ``(...)`` and ``neg_sim``
    ``(..., N)``; the mean over ``...`` of the positive's negative
    log-softmax among the ``N + 1`` logits ``sim / temperature``.

    Example
    -------
    >>> round(contrastive_loss(torch.zeros(2), torch.zeros(2, 3)).item(), 4)
    1.3863
    """
    logits = torch.cat([pos_sim[..., None], neg_sim], dim=-1) / temperature
    return -torch.log_softmax(logits, dim=-1)[..., 0].mean()
