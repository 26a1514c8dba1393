"""The port's log-mel front end against the JAX package's: the plain
version of the fused kernel against ``fused_fbank(interpret=True)`` and
against the unfused ``Fbank``, and the port's unfused ``Fbank`` against
JAX's, on the same numpy waveform.

atol 5e-3 dB is the tolerance of the JAX package's own test of its fused
kernel (float32 DFT sums of 400 terms in another order, then a log)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
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


# -- the kernel's operand layout (speechbrain_tpu_torch/csrc/mel_frontend.cu)

from speechbrain_tpu_torch.ops import mel_frontend as mf  # noqa: E402
from speechbrain_tpu_torch.utils.signals import (  # noqa: E402
    make_check_signal,
)


def _chirp(batch=2, seconds=0.5, seed=3):
    return make_check_signal("chirp", batch, int(SR * seconds), seed)


def _unpack(ops):
    """The kernel's tables back as (hi, lo), each (n_ktiles * TILE_K,
    n_chunks * TILE_COLS): samples by interleaved cos/sin columns."""
    C, K = mf.TILE_COLS, mf.TILE_K
    tiles = ops.tables.numpy().reshape(ops.n_chunks, ops.n_ktiles, 2, C, K)
    r = np.arange(C)[:, None]
    e = np.arange(K)[None, :]
    src = np.broadcast_to(((e // 4) ^ (r % 8)) * 4 + e % 4, tiles.shape)
    plain = np.take_along_axis(tiles, src, axis=-1)  # (c, kt, part, r, e)
    plain = plain.transpose(2, 1, 4, 0, 3).reshape(
        2, ops.n_ktiles * K, ops.n_chunks * C
    )
    return plain[0], plain[1]


@pytest.fixture(scope="module")
def fused80():
    return Fbank(n_mels=80, fused=True, device="cpu")


def test_tf32_round_is_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 1.5 * ulp, 3.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0], np.float32)
    np.testing.assert_array_equal(mf.tf32_round(x), want)


def test_kernel_tables_are_a_tf32_split(fused80):
    hi, lo = _unpack(fused80._operands)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    cos_m, sin_m = (t.numpy() for t in fused80._tables)
    n_fft, n_freq = cos_m.shape
    full = np.zeros_like(hi)
    full[:n_fft, 0:2 * n_freq:2] = cos_m
    full[:n_fft, 1:2 * n_freq:2] = sin_m
    back = hi.astype(np.float64) + lo.astype(np.float64)
    np.testing.assert_array_less(
        np.abs(back - full), 2.0 ** -22 * np.abs(full) + 1e-45
    )


def test_kernel_tables_map_back_to_dft_tables(fused80):
    hi, lo = _unpack(fused80._operands)
    cos_m, sin_m = (t.numpy() for t in fused80._tables)
    n_fft, n_freq = cos_m.shape
    for col, table in ((0, cos_m), (1, sin_m)):
        t_hi = mf.tf32_round(table)
        np.testing.assert_array_equal(hi[:n_fft, col:2 * n_freq:2], t_hi)
        np.testing.assert_array_equal(
            lo[:n_fft, col:2 * n_freq:2], mf.tf32_round(table - t_hi)
        )
    assert not np.any(hi[n_fft:]) and not np.any(hi[:, 2 * n_freq:])
    assert not np.any(lo[n_fft:]) and not np.any(lo[:, 2 * n_freq:])
    assert fused80._operands.n_chunks * mf.TILE_COLS >= 2 * n_freq


@pytest.mark.parametrize("n_mels,n_fft", [(80, 400), (40, 512)])
def test_kernel_mel_ranges_cover_the_matrix(n_mels, n_fft):
    fb = Fbank(n_mels=n_mels, n_fft=n_fft, fused=True, device="cpu")
    mel = fb.compute_fbanks.fbank_matrix.numpy()
    ops = fb._operands
    ranges = ops.mel_ranges.numpy()
    weights = ops.mel_weights.numpy()
    rows = np.arange(mel.shape[0])[:, None]
    inside = (rows >= ranges[:, 0]) & (rows < ranges[:, 1])
    assert not np.any(mel[~inside])  # every non-zero lies in its range
    power = np.random.default_rng(0).random((7, mel.shape[0]))
    limited = np.zeros((7, n_mels))
    for m, (first, stop) in enumerate(ranges):
        limited[:, m] = power[:, first:stop] @ weights[m, :stop - first]
    np.testing.assert_allclose(limited, power @ mel, rtol=1e-12, atol=0)


@pytest.mark.parametrize("hop", [160, 128, 256, 161, 100])
def test_span_skew_makes_fragment_loads_conflict_free(hop):
    """A fragment load: lanes (g, t) read frame g, sample n + t of the
    skewed span (frame f at f * (hop + skew)); 32 lanes, 32 banks, for
    every k8 step that does not straddle a multiple of hop."""
    skew = mf.span_skew(hop)
    assert 0 <= skew < 8
    g = np.arange(8)[:, None]
    t = np.arange(4)[None, :]
    for n0 in range(0, 400, 4):
        n = n0 + t
        if (n0 // hop) != ((n0 + 3) // hop):
            continue
        phys = g * (hop + skew) + n + skew * (n // hop)
        assert len(set((phys % 32).ravel())) == 32


def test_fused_plain_matches_jax_on_chirp():
    wav = _chirp()
    jfb = JaxFbank(n_mels=80)
    ref = np.asarray(jax_fused_fbank(
        jnp.asarray(wav), jfb.compute_STFT.window,
        jfb.compute_fbanks.fbank_matrix, n_fft=400, hop_length=160,
        top_db=jfb.compute_fbanks.top_db, interpret=True,
    ))
    out = Fbank(n_mels=80, fused=True, device="cpu")(torch.from_numpy(wav))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_three_pass_tf32_scheme_matches_jax_on_chirp(fused80):
    """The kernel's arithmetic in float64 numpy: frames split into TF32 hi
    and lo, the tables' hi and lo parts from the kernel's layout, products
    hi hi + hi lo + lo hi, power, the range-limited mel projection, dB and
    the top_db clamp; against JAX's Fbank on the chirp."""
    wav = _chirp()
    ops = fused80._operands
    hi_t, lo_t = (x.astype(np.float64) for x in _unpack(ops))
    n_fft, hop, n_freq = 400, 160, 201
    kp = hi_t.shape[0]
    padded = np.pad(wav, ((0, 0), (n_fft // 2, n_fft // 2 + kp)))
    n_frames = 1 + wav.shape[1] // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(kp)[None, :]
    frames = padded[:, idx]
    frames[..., n_fft:] = 0.0
    f_hi = mf.tf32_round(frames)
    f_lo = mf.tf32_round(frames - f_hi)
    f_hi, f_lo = f_hi.astype(np.float64), f_lo.astype(np.float64)
    prod = f_hi @ hi_t + f_hi @ lo_t + f_lo @ hi_t
    power = prod[..., 0:2 * n_freq:2] ** 2 + prod[..., 1:2 * n_freq:2] ** 2
    ranges = ops.mel_ranges.numpy()
    weights = ops.mel_weights.numpy().astype(np.float64)
    mel = np.zeros(power.shape[:-1] + (len(ranges),))
    for m, (first, stop) in enumerate(ranges):
        mel[..., m] = power[..., first:stop] @ weights[m, :stop - first]
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max(axis=(1, 2), keepdims=True) - 80.0)
    ref = np.asarray(JaxFbank(n_mels=80)(jnp.asarray(wav)))
    np.testing.assert_allclose(db, ref, atol=ATOL)
