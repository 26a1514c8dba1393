"""``TransformerASR`` under the five encoder/attention combinations of the
LibriSpeech transformer recipe's YAMLs (transformer, RoPE-Conformer,
Branchformer, HyperConformer, HyperBranchformer) against the JAX package at
a small size: encode, forward and the KV-cached decode step. The models,
their weights and the tolerance (1e-4: a few layers deep, float32 on both
sides, sums in another order) are ``test_torch_families.py``'s."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import pytest
import torch

from test_torch_families import FAMILIES, MODEL_ATOL, _asr, _close, _t


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def asr(request):
    return _asr(request.param)


def test_asr_encode_and_forward(asr):
    jnet, v, net, src, tok, lens, jenc = asr
    ref_enc, ref_dec = jnet.apply(
        v, jnp.asarray(src), jnp.asarray(tok), jnp.asarray(lens)
    )
    with torch.no_grad():
        enc = net.encode(_t(src), _t(lens))
        enc2, dec = net(_t(src), _t(tok), _t(lens))
    _close(enc, jenc, atol=MODEL_ATOL)
    _close(enc2, ref_enc, atol=MODEL_ATOL)
    _close(dec, ref_dec, atol=MODEL_ATOL)


def test_asr_decode_step(asr):
    """A forced token sequence one step at a time through the KV cache
    with the cross K/V precomputed: every step equals JAX's."""
    jnet, v, net, src, tok, lens, jenc = asr
    with torch.no_grad():
        enc = net.encode(_t(src), _t(lens))
        jcache = jnet.apply(v, jenc, 5, method="init_decoder_cache_with_cross")
        cache = net.init_decoder_cache_with_cross(enc, 5)
        for step in range(3):
            ref, jcache, ref_attn = jnet.apply(
                v, jnp.asarray(tok[:, step]), jenc, jcache, step,
                jnp.asarray(lens), method="decode_step",
            )
            out, cache, attn = net.decode_step(
                _t(tok[:, step]), enc, cache, step, _t(lens)
            )
            _close(out, ref, atol=MODEL_ATOL)
            _close(attn, ref_attn, atol=MODEL_ATOL)
