"""Row gather (kernel B4) against the JAX package, and the permuting beam
search's use of it.

On the CPU ``ops.gather.row_gather`` runs its plain version
(``index_select``); the JAX function runs its Pallas kernel in interpret
mode. A gather copies, so the two must be bitwise equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.ops import gather as jgather
from speechbrain_tpu_torch.decoders.seq2seq import S2SKVBeamSearcher
from speechbrain_tpu_torch.ops import gather as tgather

CASES = {
    # name: (shape of x, indices): repeated indices, n_out != N
    "2d_repeat": ((6, 40), [5, 0, 0, 3, 5, 1]),
    "3d_fewer": ((7, 4, 3), [6, 2, 2, 0]),
    "3d_more": ((3, 5, 8), [2, 2, 1, 0, 0, 1, 2, 1]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_row_gather_matches_jax_kernel_bitwise(name, dtype):
    shape, idx = CASES[name]
    x = np.random.default_rng(len(idx)).standard_normal(shape).astype(
        np.float32
    )
    idx = np.asarray(idx, np.int32)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(
        jgather.row_gather(jx, jnp.asarray(idx), interpret=True).astype(
            jnp.float32
        )
    )
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for index in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        out = tgather.row_gather(tx, index)
        assert out.dtype == tx.dtype and out.shape == (len(idx),) + shape[1:]
        np.testing.assert_array_equal(out.float().numpy(), ref)
    assert tgather.row_gather(tx, torch.from_numpy(idx)).data_ptr() != (
        tx.data_ptr()
    )


def test_gather_pytree_matches_jax():
    """Nested dicts and lists; 0-d tensors and non-tensors stay as they
    are."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 3, 2)).astype(np.float32)
    b = rng.standard_normal((4, 5)).astype(np.float32)
    idx = np.array([3, 3, 0, 1], np.int32)
    ref = jgather.gather_pytree(
        {"layers": [{"k": jnp.asarray(a)}, {"k": jnp.asarray(b)}],
         "step": jnp.asarray(7.0)},
        jnp.asarray(idx),
    )
    tree = {"layers": [{"k": torch.from_numpy(a)}, {"k": torch.from_numpy(b)}],
            "step": torch.tensor(7.0), "name": "lm"}
    out = tgather.gather_pytree(tree, torch.from_numpy(idx).long())
    for i in range(2):
        np.testing.assert_array_equal(
            out["layers"][i]["k"].numpy(), np.asarray(ref["layers"][i]["k"])
        )
    assert out["step"] is tree["step"] and out["name"] == "lm"
    assert float(ref["step"]) == 7.0


def test_permuting_search_gathers_self_caches_and_keeps_cross():
    """``ancestry_kv=False``: the per-layer "self" buffers are permuted by
    predecessor, the beam-shared "cross" entries are the same objects."""
    searcher = S2SKVBeamSearcher(
        None, None, bos_index=1, eos_index=2, min_decode_ratio=0.0,
        max_decode_ratio=1.0, beam_size=2, device="cpu",
    )
    rng = np.random.default_rng(4)
    memory = [
        {"self": {"k": torch.from_numpy(
            rng.standard_normal((4, 3, 8)).astype(np.float32)),
                  "v": torch.from_numpy(
            rng.standard_normal((4, 3, 8)).astype(np.float32))},
         "cross": {"k": torch.zeros(2, 1, 5, 8)}}
        for _ in range(2)
    ]
    idx = torch.tensor([1, 1, 2, 3])
    out = searcher.permute_mem(memory, idx)
    for old, new in zip(memory, out):
        assert new["cross"] is old["cross"]
        for key in ("k", "v"):
            assert torch.equal(new["self"][key], old["self"][key][idx])
