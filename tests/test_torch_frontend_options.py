"""The front-end options around kernel B3 against the JAX package, at a
small size: ``frame_signal``'s pad modes, ``STFT`` (reflect and replicate
padding, two-sided spectra, multi-channel input) and its ``power``,
``DCT``, ``Deltas``, ``ContextWindow``, ``MinLevelNorm``,
``DynamicRangeCompression``, ``Fbank(deltas=, context=)`` on the fused arm
(on the CPU the kernel's plain version, against JAX's fused kernel in
interpret mode) and the unfused one, ``MFCC``, and
``ConvolutionFrontEnd(norm="batchnorm")`` in evaluation and training mode
(its running statistics too).

Tolerances: 1e-5 relative to the largest magnitude for spectra (float32
FFTs in another order); 1e-5 absolute on DCT, deltas and context, which
are exact rearrangements or short sums; 1e-4 dB on the unfused Fbank's
features (dB values in the tens); 5e-3 dB on the fused arm's log-mels
(the tolerance of the JAX package's own test of its fused kernel), and on
their deltas 0.6 of it (a delta's weights sum to 6/10 in absolute value)
and 0.36 on the second; 1e-4 on MFCCs (a DCT of dB values in the tens).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechbrain_tpu.lobes import features as jlf
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.ops import mel_frontend as jmel
from speechbrain_tpu.processing import features as jf
from speechbrain_tpu_torch.lobes import features as tlf
from speechbrain_tpu_torch.lobes.models.convolution import (
    ConvolutionFrontEnd,
)
from speechbrain_tpu_torch.processing import features as tf
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _t, _x, draw_variables, japply

ATOL = 1e-5
B3_ATOL = 5e-3  # dB
SR = 16000


def _rel_close(ours, theirs, rtol=1e-5):
    theirs = np.asarray(theirs)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs,
                               atol=rtol * np.abs(theirs).max())


@pytest.mark.parametrize("pad_mode", ["constant", "reflect", "replicate"])
def test_frame_signal_pad_modes_match_jax(pad_mode):
    x = _x((2, 3, 50))
    ours = tf.frame_signal(_t(x), 16, 5, center=True, pad_mode=pad_mode)
    theirs = jf.frame_signal(jnp.asarray(x), 16, 5, center=True,
                             pad_mode=pad_mode)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("pad_mode", ["constant", "reflect", "replicate"])
@pytest.mark.parametrize("onesided", [True, False])
@pytest.mark.parametrize("channels", [0, 2])
def test_stft_options_match_jax(pad_mode, onesided, channels):
    shape = (2, 3200, channels) if channels else (2, 3200)
    x = _x(shape, seed=1)
    kw = dict(pad_mode=pad_mode, onesided=onesided, normalized_stft=True)
    ours = tf.STFT(SR, device="cpu", **kw)
    theirs = jf.STFT(SR, **kw)
    _rel_close(ours(_t(x)), theirs(jnp.asarray(x)))
    # power is one-sided whatever onesided says, in both packages
    _rel_close(ours.power(_t(x)), theirs.power(jnp.asarray(x)))


def test_stft_rejects_an_unknown_pad_mode():
    with pytest.raises(ValueError, match="pad_mode"):
        tf.STFT(SR, pad_mode="wrap", device="cpu")


@pytest.mark.parametrize("shape", [(2, 9, 12), (2, 9, 12, 3)])
def test_dct_deltas_context_match_jax(shape):
    x = _x(shape, seed=2)
    pairs = [
        (tf.DCT(12, n_out=5, device="cpu"), jf.DCT(12, n_out=5)),
        (tf.DCT(12, n_out=12, ortho_norm=False, device="cpu"),
         jf.DCT(12, n_out=12, ortho_norm=False)),
        (tf.Deltas(12), jf.Deltas(12)),
        (tf.Deltas(window_length=7), jf.Deltas(window_length=7)),
        (tf.ContextWindow(3, 2), jf.ContextWindow(3, 2)),
        (tf.ContextWindow(0, 4), jf.ContextWindow(0, 4)),
    ]
    for ours, theirs in pairs:
        out = ours(_t(x))
        ref = np.asarray(theirs(jnp.asarray(x)))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    with pytest.raises(ValueError):
        tf.DCT(4, n_out=5, device="cpu")


def test_level_norms_match_jax():
    x = np.linspace(-130.0, 20.0, 31, dtype=np.float32)
    norm, jnorm = tf.MinLevelNorm(-100.0), jf.MinLevelNorm(-100.0)
    np.testing.assert_allclose(norm(_t(x)).numpy(),
                               np.asarray(jnorm(jnp.asarray(x))), atol=ATOL)
    y = np.linspace(-1.5, 1.5, 13, dtype=np.float32)
    np.testing.assert_allclose(norm.denormalize(_t(y)).numpy(),
                               np.asarray(jnorm.denormalize(jnp.asarray(y))),
                               atol=ATOL)
    p = np.abs(_x((3, 7), seed=3)) * np.float32(1e-4)
    for kw in ({}, {"multiplier": 3.0, "clip_val": 1e-6}):
        np.testing.assert_allclose(
            tf.DynamicRangeCompression(**kw)(_t(p)).numpy(),
            np.asarray(jf.DynamicRangeCompression(**kw)(jnp.asarray(p))),
            atol=ATOL)


def _wavs(seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(4000) / SR
    return (0.4 * np.sin(2 * np.pi * 440 * t * (1 + t))[None]
            + 0.05 * rng.standard_normal((2, 4000))).astype(np.float32)


@pytest.mark.parametrize("deltas,context", [(True, False), (False, True),
                                            (True, True)])
def test_fbank_deltas_and_context_match_jax(monkeypatch, deltas, context):
    """The unfused arm against JAX's unfused Fbank; the fused arm against
    JAX's fused kernel in interpret mode, Δ and ΔΔ within the bound the
    log-mels' 5e-3 dB implies."""
    wav = _wavs()
    kw = dict(deltas=deltas, context=context, n_mels=20, left_frames=2,
              right_frames=3)
    unfused = tlf.Fbank(**kw, device="cpu")(_t(wav))
    np.testing.assert_allclose(
        unfused.numpy(), np.asarray(jlf.Fbank(**kw)(jnp.asarray(wav))),
        atol=1e-4)
    monkeypatch.setattr(jmel, "fused_fbank",
                        functools.partial(jmel.fused_fbank, interpret=True))
    fused = tlf.Fbank(**kw, fused=True, device="cpu")(_t(wav)).numpy()
    ref = np.asarray(jlf.Fbank(**kw, fused=True)(jnp.asarray(wav)))
    assert fused.shape == ref.shape == unfused.shape
    n = 20
    width = 3 * n if deltas else n
    blocks = fused.reshape(*fused.shape[:2], -1, width)
    ref_blocks = ref.reshape(blocks.shape)
    bounds = [B3_ATOL, 0.6 * B3_ATOL, 0.36 * B3_ATOL] if deltas else [B3_ATOL]
    for i, bound in enumerate(bounds):
        np.testing.assert_allclose(blocks[..., i * n:(i + 1) * n],
                                   ref_blocks[..., i * n:(i + 1) * n],
                                   atol=bound)


def test_fbank_feature_width():
    fb = tlf.Fbank(deltas=True, context=True, device="cpu")
    assert fb(torch.zeros(1, 1600)).shape == (1, 11, 40 * 3 * 11)


@pytest.mark.parametrize("kw", [{}, {"deltas": False, "context": False,
                                     "n_mels": 30, "n_mfcc": 13}])
def test_mfcc_matches_jax(kw):
    wav = _wavs(seed=5)
    ours = tlf.MFCC(**kw, device="cpu")(_t(wav))
    theirs = np.asarray(jlf.MFCC(**kw)(jnp.asarray(wav)))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4)


def test_mfcc_stays_float32_under_autocast():
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = tlf.MFCC(device="cpu")(torch.zeros(1, 1600))
    assert out.dtype == torch.float32


def test_batchnorm_frontend_matches_jax():
    """Evaluation mode with the bridged running statistics; a training
    forward at dropout 0 on batch statistics, and the updated running
    statistics against flax's; ``residuals`` taken and not read."""
    x = _x((3, 24, 16), seed=6)
    kw = dict(num_blocks=2, out_channels=(4, 6), kernel_sizes=(3, 3),
              strides=(2, 2), norm="batchnorm", dropout=0.0,
              residuals=(False, True))
    jm = JaxFrontEnd(**kw)
    variables = draw_variables(jm, jnp.asarray(x), train=False, seed=7)
    tm = load(ConvolutionFrontEnd(**kw, device="cpu"), variables)
    np.testing.assert_allclose(
        tm.eval()(_t(x)).detach().numpy(),
        np.asarray(japply(jm, variables, jnp.asarray(x), train=False)),
        atol=ATOL)
    j_out, j_new = japply(jm, variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    np.testing.assert_allclose(tm.train()(_t(x)).detach().numpy(),
                               np.asarray(j_out), atol=ATOL)
    for b in range(2):
        stats = j_new["batch_stats"][f"norm_{b}"]["BatchNorm_0"]
        norm = tm.norms[f"norm_{b}"]
        np.testing.assert_allclose(norm.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=ATOL)
        np.testing.assert_allclose(norm.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=ATOL)
    with pytest.raises(ValueError, match="norm"):
        ConvolutionFrontEnd(norm="groupnorm", device="cpu")
