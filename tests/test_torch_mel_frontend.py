"""The port's log-mel front end against the JAX package's: the plain
version of the fused kernel against ``fused_fbank(interpret=True)`` and
against the unfused ``Fbank``, and the port's unfused ``Fbank`` against
JAX's, on the same numpy waveform.

atol 5e-3 dB is the tolerance of the JAX package's own test of its fused
kernel (float32 DFT sums of 400 terms in another order, then a log)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.ops.mel_frontend import fused_fbank as jax_fused_fbank
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.processing.features import (
    hamming_window,
    mel_filterbank_matrix,
)

ATOL = 5e-3
SR = 16000


def _wav(seconds=0.5, batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, int(SR * seconds))
    ).astype(np.float32)


@pytest.mark.parametrize("hop", [160, 128, 256])
def test_fused_plain_matches_jax(hop):
    wav = _wav()
    hop_ms = hop * 1000 // SR
    jfb = JaxFbank(n_mels=80, hop_length=hop_ms)
    ref_unfused = np.asarray(jfb(jnp.asarray(wav)))
    ref_fused = np.asarray(jax_fused_fbank(
        jnp.asarray(wav), jfb.compute_STFT.window,
        jfb.compute_fbanks.fbank_matrix, n_fft=jfb.compute_STFT.n_fft,
        hop_length=hop, top_db=jfb.compute_fbanks.top_db, interpret=True,
    ))
    fb = Fbank(n_mels=80, hop_length=hop_ms, fused=True, device="cpu")
    assert fb.compute_STFT.hop_length == hop
    out = fb(torch.from_numpy(wav)).numpy()
    assert out.shape == ref_fused.shape == ref_unfused.shape
    np.testing.assert_allclose(out, ref_fused, atol=ATOL)
    np.testing.assert_allclose(out, ref_unfused, atol=ATOL)


@pytest.mark.parametrize("n_mels", [40, 80])
def test_unfused_fbank_matches_jax(n_mels):
    wav = _wav(seed=n_mels)
    ref = np.asarray(JaxFbank(n_mels=n_mels)(jnp.asarray(wav)))
    fb = Fbank(n_mels=n_mels, device="cpu")
    out = fb(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    fused = Fbank(n_mels=n_mels, fused=True, device="cpu")
    np.testing.assert_allclose(
        fused(torch.from_numpy(wav)).numpy(), out, atol=ATOL
    )


def test_stft_matches_jax():
    from speechbrain_tpu.processing.features import STFT as JaxSTFT
    from speechbrain_tpu_torch.processing.features import STFT

    wav = _wav(seconds=0.2)
    ref = JaxSTFT(sample_rate=SR)
    out = STFT(sample_rate=SR, device="cpu")
    np.testing.assert_array_equal(out.window.numpy(), np.asarray(ref.window))
    # spectra of unit-variance noise reach a few tens; float32 FFTs in
    # another order
    np.testing.assert_allclose(
        out(torch.from_numpy(wav)).numpy(), np.asarray(ref(jnp.asarray(wav))),
        atol=1e-3,
    )
    np.testing.assert_allclose(
        out.power(torch.from_numpy(wav)).numpy(),
        np.asarray(ref.power(jnp.asarray(wav))), rtol=1e-4, atol=1e-3,
    )


def test_top_db_clamp_is_per_sequence():
    wav = _wav()
    wav[1] *= 1e-3  # a quiet utterance keeps its own 80 dB floor
    out = Fbank(n_mels=40, fused=True, device="cpu")(torch.from_numpy(wav))
    spans = out.amax(dim=(1, 2)) - out.amin(dim=(1, 2))
    assert float(out.amax(dim=(1, 2))[0] - out.amax(dim=(1, 2))[1]) > 50
    assert torch.all(spans <= 80.0 + 1e-4)


def test_constants_are_copies_of_the_jax_package():
    from speechbrain_tpu.processing import features as jf

    np.testing.assert_array_equal(hamming_window(400), jf.hamming_window(400))
    np.testing.assert_array_equal(
        mel_filterbank_matrix(80, 400, SR, 0.0, 8000.0),
        jf.mel_filterbank_matrix(80, 400, SR, 0.0, 8000.0),
    )
