"""Flash attention (kernel B2) and its entry points against the JAX package.

On the CPU ``ops.attention.flash_attention`` runs its plain version; the
JAX function runs its Pallas kernel in interpret mode. The port's
``scaled_dot_product_attention(use_pallas=True)`` and
``MultiheadAttention(use_pallas=True)`` are held against JAX's
counterparts, which take their XLA path on the CPU. Inputs from numpy,
weights from flax's init carried over by ``utils/jax_bridge``.

atol 1e-5: float32 products and softmax sums in another order (the
tolerance of the JAX package's own kernel test). No query row is masked in
full: there the JAX kernel's padded keys and the unfused path disagree, and
the port follows the unfused path.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax

from speechbrain_tpu.nnet import attention as jatt
from speechbrain_tpu.ops.attention import flash_attention as jax_flash
from speechbrain_tpu_torch.nnet import attention as tatt
from speechbrain_tpu_torch.ops import attention as tops
from speechbrain_tpu_torch.utils.jax_bridge import load

ATOL = 1e-5
JAX_NEG_INF = -1e30


def _t(a):
    return torch.from_numpy(np.array(a))


def _bias(kind, B, H, Tq, Tk, rng):
    if kind == "none":
        return None
    if kind == "causal":
        # (Tq, Tk): query i sees keys up to i + max(0, Tk - Tq), so no
        # row is empty
        return np.triu(
            np.full((Tq, Tk), JAX_NEG_INF, np.float32),
            k=max(1, Tk - Tq + 1),
        )
    bias = rng.standard_normal((B, H, Tq, Tk)).astype(np.float32)
    bias[..., Tk // 2:] += np.where(
        rng.random((B, H, Tq, Tk - Tk // 2)) < 0.5, JAX_NEG_INF, 0.0
    ).astype(np.float32)
    return bias


@pytest.mark.parametrize("kind", ["none", "causal", "full"])
@pytest.mark.parametrize("Tq,Tk", [(40, 70), (70, 40)])
def test_flash_attention_matches_jax_kernel(kind, Tq, Tk):
    B, H, D = 2, 3, 32
    rng = np.random.default_rng(Tq + Tk + len(kind))
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    bias = _bias(kind, B, H, Tq, Tk, rng)
    ref, ref_w = jax_flash(q, k, v, bias, interpret=True)
    out, w = tops.flash_attention(
        _t(q), _t(k), _t(v), None if bias is None else _t(bias)
    )
    assert ref_w is None and w is None
    assert out.shape == (B, H, Tq, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mask", ["key_padding", "causal"])
def test_sdpa_use_pallas_matches_jax(mask):
    """The port's ``make_mask_bias`` forms, (B, 1, 1, Tk) and
    (1, 1, Tq, Tk), go into the kernel's function as they are."""
    B, H, T, D = 2, 2, 40, 32
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    if mask == "key_padding":
        kpm = np.zeros((B, T), bool)
        kpm[1, 29:] = True
        jbias = jatt.make_mask_bias(key_padding_mask=kpm)
        tbias = tatt.make_mask_bias(key_padding_mask=_t(kpm))
    else:
        am = np.triu(np.ones((T, T), bool), k=1)
        jbias = jatt.make_mask_bias(attn_mask=am)
        tbias = tatt.make_mask_bias(attn_mask=_t(am))
    ref, _ = jatt.scaled_dot_product_attention(
        q, k, v, jbias, use_pallas=True
    )
    out, w = tatt.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), tbias, use_pallas=True
    )
    assert w is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def mha_pair():
    D, H = 64, 2
    x = np.random.default_rng(0).standard_normal((2, 40, D)).astype(
        np.float32
    )
    jm = jatt.MultiheadAttention(nhead=H, d_model=D, use_pallas=True)
    v = jm.init(jax.random.PRNGKey(0), x, x, x)
    leaves, tree = jax.tree_util.tree_flatten(v)
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_unflatten(tree, [
        np.asarray(leaf) + 0.1 * rng.standard_normal(leaf.shape).astype(
            np.float32
        )
        for leaf in leaves
    ])
    tm = load(
        tatt.MultiheadAttention(
            nhead=H, d_model=D, use_pallas=True, device="cpu"
        ).eval(),
        v,
    )
    return jm, v, tm, x


@pytest.mark.parametrize("mask", ["key_padding", "causal"])
def test_mha_use_pallas_matches_jax(mha_pair, mask):
    jm, v, tm, x = mha_pair
    T = x.shape[1]
    kw = {}
    if mask == "key_padding":
        kpm = np.zeros((2, T), bool)
        kpm[0, 33:] = True
        kw["key_padding_mask"] = kpm
    else:
        kw["attn_mask"] = np.triu(np.ones((T, T), bool), k=1)
    ref, ref_w = jm.apply(v, x, x, x, **kw)
    with torch.no_grad():
        out, w = tm(_t(x), _t(x), _t(x), **{k: _t(a) for k, a in kw.items()})
        tm.use_pallas = False
        plain, plain_w = tm(
            _t(x), _t(x), _t(x), **{k: _t(a) for k, a in kw.items()}
        )
        tm.use_pallas = True
    # JAX's use_pallas=True falls back to its XLA path here and returns
    # weights; the port returns none, as JAX's kernel path would
    assert w is None and ref_w is not None and plain_w is not None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=ATOL)


def test_use_pallas_refuses_dropout_in_training():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="no dropout"):
        tatt.scaled_dot_product_attention(
            q, q, q, dropout_rate=0.1, training=True, use_pallas=True
        )
    mha = tatt.MultiheadAttention(
        nhead=2, d_model=64, dropout=0.1, use_pallas=True, device="cpu"
    ).train()
    x = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="no dropout"):
        mha(x, x, x)
    # in eval the same module runs, dropout or not
    out, w = mha.eval()(x, x, x)
    assert out.shape == (1, 4, 64) and w is None
