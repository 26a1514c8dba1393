"""``MultiheadAttention`` in its five call modes, ``RelPosMHAXL`` and the
helpers around them, against the JAX package: weights made by flax's init,
perturbed, and carried across by ``utils/jax_bridge``; inputs from numpy.

atol 1e-5: float32 matrix products and softmax sums in another order."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.nnet import attention as jatt
from speechbrain_tpu_torch.nnet import attention as tatt
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-5
D, H = 32, 4


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(v, seed=1):
    """flax initialises biases and pos_bias_u/v to zero; give every leaf a
    value so that a dropped or swapped parameter shows."""
    leaves, tree = jax.tree_util.tree_flatten(v)
    rng = np.random.default_rng(seed)
    leaves = [
        leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        for leaf in leaves
    ]
    return jax.tree_util.tree_unflatten(tree, leaves)


@pytest.fixture(scope="module")
def mha():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    mem = rng.standard_normal((2, 9, D)).astype(np.float32)
    jm = jatt.MultiheadAttention(nhead=H, d_model=D)
    v = _perturb(jm.init(jax.random.PRNGKey(0), x, mem, mem))
    tm = load(
        tatt.MultiheadAttention(nhead=H, d_model=D, device="cpu").eval(),
        _np_tree(v),
    )
    return jm, v, tm, x, mem


def test_mha_plain_call_with_masks(mha):
    jm, v, tm, x, mem = mha
    kpm = np.zeros((2, 9), bool)
    kpm[1, 6:] = True
    am = np.triu(np.ones((6, 9), bool), k=4)
    ref, ref_w = jm.apply(v, x, mem, mem, attn_mask=am, key_padding_mask=kpm)
    out, w = tm(_t(x), _t(mem), _t(mem), attn_mask=_t(am),
                key_padding_mask=_t(kpm))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(w.detach().numpy(), ref_w, atol=ATOL)


def test_mha_return_kv_only_is_head_major(mha):
    jm, v, tm, x, mem = mha
    ref = jm.apply(v, x, mem, mem, return_kv_only=True)
    out = tm(_t(x), _t(mem), _t(mem), return_kv_only=True)
    for key in ("k", "v"):
        assert out[key].shape == (2, H, 9, D // H)
        np.testing.assert_allclose(
            out[key].detach().numpy(), ref[key], atol=ATOL
        )


def test_mha_precomputed_kv(mha):
    jm, v, tm, x, mem = mha
    kpm = np.zeros((2, 9), bool)
    kpm[0, 7:] = True
    jkv = jm.apply(v, x, mem, mem, return_kv_only=True)
    tkv = tm(_t(x), _t(mem), _t(mem), return_kv_only=True)
    ref, ref_w = jm.apply(
        v, x, mem, mem, key_padding_mask=kpm, precomputed_kv=jkv
    )
    out, w = tm(_t(x), _t(mem), _t(mem), key_padding_mask=_t(kpm),
                precomputed_kv=tkv)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(w.detach().numpy(), ref_w, atol=ATOL)


def test_mha_precomputed_kv_shared_over_beams(mha):
    """K/V hold one entry per utterance, queries are beam-inflated; the
    padding mask of beam 0 serves the whole utterance."""
    jm, v, tm, _, mem = mha
    G = 3
    q = np.random.default_rng(3).standard_normal(
        (2 * G, 1, D)
    ).astype(np.float32)
    kpm = np.zeros((2, 9), bool)
    kpm[1, 5:] = True
    kpm_inflated = np.repeat(kpm, G, axis=0)
    mem_inflated = np.repeat(mem, G, axis=0)
    jkv = jm.apply(v, mem, mem, mem, return_kv_only=True)
    tkv = tm(_t(mem), _t(mem), _t(mem), return_kv_only=True)
    ref, ref_w = jm.apply(
        v, q, mem_inflated, mem_inflated, key_padding_mask=kpm_inflated,
        precomputed_kv=jkv,
    )
    out, w = tm(_t(q), _t(mem_inflated), _t(mem_inflated),
                key_padding_mask=_t(kpm_inflated), precomputed_kv=tkv)
    assert out.shape == (2 * G, 1, D) and w.shape == (2 * G, 1, 9)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(w.detach().numpy(), ref_w, atol=ATOL)


def _cache(B, L):
    return {"k": np.zeros((B, L, D), np.float32),
            "v": np.zeros((B, L, D), np.float32)}


def test_mha_cached_steps(mha):
    """Three incremental steps; the port writes its cache in place, JAX
    returns a new one: both must hold the same rows afterwards."""
    jm, v, tm, _, _ = mha
    B, L = 3, 8
    rng = np.random.default_rng(4)
    jcache = {k: jnp.asarray(a) for k, a in _cache(B, L).items()}
    tcache = {k: _t(a) for k, a in _cache(B, L).items()}
    for step in range(3):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        ref, ref_w, jcache = jm.apply(
            v, x, x, x, cache=jcache, cache_index=step
        )
        out, w, returned = tm(_t(x), _t(x), _t(x), cache=tcache,
                              cache_index=step)
        assert returned is tcache
        assert w.shape == (B, 1, L)
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
        np.testing.assert_allclose(w.detach().numpy(), ref_w, atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache[key].detach().numpy(), jcache[key], atol=ATOL
        )


def test_mha_cached_steps_through_ancestry(mha):
    """cache + anc: rows never move, the ancestry table picks them; no
    attention weights come back."""
    jm, v, tm, _, _ = mha
    B_utt, K, L = 2, 3, 8
    rng = np.random.default_rng(5)
    filled = {
        k: rng.standard_normal((B_utt * K, L, D)).astype(np.float32)
        for k in ("k", "v")
    }
    anc = rng.integers(0, K, (B_utt, K, L)).astype(np.int32)
    step = 4
    anc[:, :, step] = np.arange(K)[None]
    x = rng.standard_normal((B_utt * K, 1, D)).astype(np.float32)
    ref, ref_w, jcache = jm.apply(
        v, x, x, x, cache={k: jnp.asarray(a) for k, a in filled.items()},
        cache_index=step, anc=jnp.asarray(anc),
    )
    tcache = {k: _t(a.copy()) for k, a in filled.items()}
    out, w, _ = tm(_t(x), _t(x), _t(x), cache=tcache, cache_index=step,
                   anc=_t(anc))
    assert ref_w is None and w is None
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(
        tcache["k"].detach().numpy(), jcache["k"], atol=ATOL
    )


def test_relpos_mha_xl():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[1, 5:] = True
    jm = jatt.RelPosMHAXL(embed_dim=D, num_heads=H)
    pe = jatt.RelPosEncXL(emb_dim=D)(jnp.asarray(x))
    v = _perturb(jm.init(jax.random.PRNGKey(0), x, x, x, pos_embs=pe))
    tm = load(
        tatt.RelPosMHAXL(embed_dim=D, num_heads=H, device="cpu").eval(),
        _np_tree(v),
    )
    tpe = tatt.RelPosEncXL(emb_dim=D)(_t(x))
    np.testing.assert_allclose(tpe.numpy(), np.asarray(pe), atol=1e-7)
    ref, ref_w = jm.apply(v, x, x, x, key_padding_mask=kpm, pos_embs=pe)
    out, w = tm(_t(x), _t(x), _t(x), key_padding_mask=_t(kpm), pos_embs=tpe)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(w.detach().numpy(), ref_w, atol=ATOL)
    # pos_embs=None builds the same table inside
    out2, _ = tm(_t(x), _t(x), _t(x), key_padding_mask=_t(kpm))
    np.testing.assert_allclose(
        out2.detach().numpy(), out.detach().numpy(), atol=1e-7
    )


def test_rel_shift_and_mask_bias():
    x = np.random.default_rng(7).standard_normal(
        (2, 3, 5, 9)
    ).astype(np.float32)
    np.testing.assert_array_equal(
        tatt._rel_shift(_t(x)).numpy(), np.asarray(jatt._rel_shift(x))
    )
    kpm = np.array([[False, True, True], [False, False, True]])
    am = np.triu(np.ones((4, 3), bool), k=1)
    np.testing.assert_array_equal(
        tatt.make_mask_bias(_t(kpm), _t(am)).numpy(),
        np.asarray(jatt.make_mask_bias(kpm, am)),
    )
    assert tatt.make_mask_bias() is None


def test_positionalwise_feed_forward_gelu_is_tanh_form():
    x = np.random.default_rng(8).standard_normal((2, 5, D)).astype(np.float32)
    jm = jatt.PositionalwiseFeedForward(d_ffn=48, activation="gelu")
    v = _perturb(jm.init(jax.random.PRNGKey(0), x))
    tm = load(
        tatt.PositionalwiseFeedForward(
            d_ffn=48, input_size=D, activation="gelu", device="cpu"
        ).eval(),
        _np_tree(v),
    )
    np.testing.assert_allclose(
        tm(_t(x)).detach().numpy(), jm.apply(v, x), atol=ATOL
    )


def test_bridge_refuses_missing_and_unused_keys(mha):
    _, v, _, _, _ = mha
    tree = _np_tree(v)["params"]
    tm = tatt.MultiheadAttention(nhead=H, d_model=D, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load(tm, {k: p for k, p in tree.items() if k != "v_proj"})
    with pytest.raises(KeyError, match="unused"):
        load(tm, {**tree, "extra": {"kernel": np.zeros((1, 1))}})
