"""The port's sequence losses against ``speechbrain_tpu.nnet.losses`` on
the same numpy inputs: ``nll_loss``, ``kldiv_loss`` (label smoothing, pad
tokens) and ``ctc_loss`` under every reduction, with relative lengths
that leave padding, and ``compute_length_mask``.

Tolerance: 1e-5 relative and 1e-6 absolute for the masked sums (float32
on both sides, summed in another order); 2e-5 relative for CTC, whose
forward recursion runs over up to 40 frames in another order (optax's
against torch's). On an alignment that cannot be made optax gives about
1e5 (its ``log_epsilon``), and so does the port (the last test)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.nnet import losses as jl
from speechbrain_tpu_torch.nnet import losses as tl

RTOL, ATOL = 1e-5, 1e-6
REDUCTIONS = ["mean", "batchmean", "batch", "sum", None]


def _log_probs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


# (B, N, K) with relative lengths that leave padding; 7 * 0.5 = 3.5 and
# 7 * (5/14) = 2.5 round half to even on both sides
LENGTHS = np.array([1.0, 0.5, 5 / 14, 6 / 7], np.float32)


def test_compute_length_mask():
    data = np.zeros((4, 7, 3), np.float32)
    for dim in (1,):
        j = jl.compute_length_mask(jnp.asarray(data), jnp.asarray(LENGTHS),
                                   len_dim=dim)
        t = tl.compute_length_mask(torch.from_numpy(data),
                                   torch.from_numpy(LENGTHS), len_dim=dim)
        assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_nll_loss(reduction, smoothing):
    rng = np.random.default_rng(0)
    logp = _log_probs(rng, (4, 7, 11))
    targets = rng.integers(0, 11, (4, 7)).astype(np.int32)
    j = jl.nll_loss(jnp.asarray(logp), jnp.asarray(targets),
                    jnp.asarray(LENGTHS), label_smoothing=smoothing,
                    reduction=reduction)
    t = tl.nll_loss(torch.from_numpy(logp), torch.from_numpy(targets),
                    torch.from_numpy(LENGTHS), label_smoothing=smoothing,
                    reduction=reduction)
    _close(t, j)


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_nll_loss_without_time_axis(reduction):
    rng = np.random.default_rng(1)
    logp = _log_probs(rng, (5, 6))
    targets = rng.integers(0, 6, 5).astype(np.int32)
    j = jl.nll_loss(jnp.asarray(logp), jnp.asarray(targets),
                    label_smoothing=0.2, reduction=reduction)
    t = tl.nll_loss(torch.from_numpy(logp), torch.from_numpy(targets),
                    label_smoothing=0.2, reduction=reduction)
    _close(t, j)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_kldiv_loss_masks_lengths_and_pad_tokens(reduction, smoothing):
    rng = np.random.default_rng(2)
    logp = _log_probs(rng, (4, 7, 11))
    targets = rng.integers(1, 11, (4, 7)).astype(np.int32)
    targets[0, 2] = targets[3, 0] = 0  # pad tokens inside the lengths
    j = jl.kldiv_loss(jnp.asarray(logp), jnp.asarray(targets),
                      jnp.asarray(LENGTHS), label_smoothing=smoothing,
                      reduction=reduction)
    t = tl.kldiv_loss(torch.from_numpy(logp), torch.from_numpy(targets),
                      torch.from_numpy(LENGTHS), label_smoothing=smoothing,
                      reduction=reduction)
    _close(t, j)


def _ctc_inputs(seed, B=3, T=40, K=12, N=9):
    """Log-probs, targets and relative lengths whose alignments can all
    be made: each target fits its input with room for repeated labels."""
    rng = np.random.default_rng(seed)
    logp = _log_probs(rng, (B, T, K))
    targets = rng.integers(1, K, (B, N)).astype(np.int32)
    in_lens = np.array([1.0, 0.75, 0.5], np.float32)[:B]
    tgt_lens = np.array([1.0, 5 / 9, 3 / 9], np.float32)[:B]
    targets[1, 5:] = 0
    targets[2, 3:] = 0
    return logp, targets, in_lens, tgt_lens


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
@pytest.mark.parametrize("blank", [0, 11])
def test_ctc_loss(reduction, blank):
    logp, targets, in_lens, tgt_lens = _ctc_inputs(3)
    if blank:
        targets = np.where(targets > 0, targets - 1, 0).astype(np.int32)
    j = jl.ctc_loss(jnp.asarray(logp), jnp.asarray(targets),
                    jnp.asarray(in_lens), jnp.asarray(tgt_lens),
                    blank_index=blank, reduction=reduction)
    t = tl.ctc_loss(torch.from_numpy(logp), torch.from_numpy(targets),
                    torch.from_numpy(in_lens), torch.from_numpy(tgt_lens),
                    blank_index=blank, reduction=reduction)
    _close(t, j, rtol=2e-5)


def test_ctc_loss_gradient_matches():
    import jax

    logp, targets, in_lens, tgt_lens = _ctc_inputs(4)
    jg = jax.grad(lambda x: jl.ctc_loss(
        x, jnp.asarray(targets), jnp.asarray(in_lens),
        jnp.asarray(tgt_lens), blank_index=0))(jnp.asarray(logp))
    x = torch.from_numpy(logp).requires_grad_(True)
    tl.ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(in_lens),
                torch.from_numpy(tgt_lens), blank_index=0).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=2e-6)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
def test_ctc_loss_infeasible_alignment_differs_from_optax(reduction):
    """Row 0 cannot be aligned: 6 labels with a repeat need 7 frames and
    the input has 4 (half of 8); row 1 can, its last label equal to the
    padding label. The port gives optax's large finite value on row 0 and
    F.ctc_loss's on row 1, each with optax's gradient. Tolerances: 1e-6
    relative on the loss (about 2e5 on row 0; float32 sums in the same
    order, rounded apart by the last bits), 2e-6 absolute on the
    gradient (as for alignable rows above)."""
    import jax

    logp = _log_probs(np.random.default_rng(5), (2, 8, 5))
    targets = np.array([[1, 1, 2, 3, 4, 2], [3, 4, 2, 0, 0, 0]], np.int32)
    in_lens = np.array([0.5, 1.0], np.float32)
    tgt_lens = np.array([1.0, 0.5], np.float32)

    def jloss(x):
        return jl.ctc_loss(x, jnp.asarray(targets), jnp.asarray(in_lens),
                           jnp.asarray(tgt_lens), blank_index=0,
                           reduction=reduction)

    j = jloss(jnp.asarray(logp))
    jg = jax.grad(lambda x: jnp.sum(jloss(x)))(jnp.asarray(logp))
    x = torch.from_numpy(logp).requires_grad_(True)
    t = tl.ctc_loss(x, torch.from_numpy(targets), torch.from_numpy(in_lens),
                    torch.from_numpy(tgt_lens), blank_index=0,
                    reduction=reduction)
    t.sum().backward()
    assert torch.isfinite(t).all() and np.max(np.asarray(j)) > 1e3
    _close(t, j, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=2e-6)
