"""The port's plain ancestry attention against the JAX package's reference
and against its Pallas kernel in interpret mode, on the same numpy inputs.

float32, atol 1e-5: the three compute the same sums in float32 in another
order."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.ops.beam_attention import (
    _ancestry_attention_pallas,
    ancestry_attention_reference as jax_reference,
)
from speechbrain_tpu_torch.ops.beam_attention import (
    ancestry_attention,
    ancestry_attention_reference,
)

ATOL = 1e-5


def _inputs(B, K, H, hd, L, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, L, H * hd)).astype(np.float32)
    v = rng.standard_normal((B, K, L, H * hd)).astype(np.float32)
    anc = rng.integers(0, K, (B, K, L)).astype(np.int32)
    return q, k, v, anc


def _torch_out(fn, q, k, v, anc, step):
    return fn(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(anc), step,
    ).numpy()


# L = 40 is not a multiple of the Pallas kernel's 32-position tile
@pytest.mark.parametrize("step", [0, 7, 31, 32, 39])
def test_plain_matches_jax_reference(step):
    q, k, v, anc = _inputs(2, 3, 4, 16, 40, seed=step)
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
        step,
    ))
    out = _torch_out(ancestry_attention_reference, q, k, v, anc, step)
    assert out.shape == ref.shape == (2, 3, 64)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("step", [0, 33, 39])
def test_plain_matches_pallas_interpret(step):
    q, k, v, anc = _inputs(2, 3, 2, 64, 40, seed=100 + step)
    ref = np.asarray(_ancestry_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
        step, interpret=True,
    ))
    out = _torch_out(ancestry_attention_reference, q, k, v, anc, step)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_wrapper_uses_plain_version_on_cpu_tensors():
    q, k, v, anc = _inputs(1, 2, 2, 32, 8, seed=5)
    np.testing.assert_array_equal(
        _torch_out(ancestry_attention, q, k, v, anc, 3),
        _torch_out(ancestry_attention_reference, q, k, v, anc, 3),
    )


def test_bfloat16_output_dtype_and_values():
    q, k, v, anc = _inputs(1, 3, 2, 32, 16, seed=9)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out = ancestry_attention_reference(
        *[a.bfloat16() for a in args], torch.from_numpy(anc), 9
    )
    ref = ancestry_attention_reference(*args, torch.from_numpy(anc), 9)
    assert out.dtype == torch.bfloat16
    # inputs rounded to bfloat16 (8 bits of mantissa), output rounded once
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=5e-2)
