"""The port's native host code against the JAX package's: the edit-distance
core (``utils/_editdist.cpp`` through ``editdist_native.edit_ops_batch``)
and the WAV decoder (``io/_audioio.cpp`` through ``io/native.py``), each
built with g++ from the port's own copy into ``speechbrain_tpu_torch/_build/``.

Edit counts are integers and held exactly: port against JAX, and the port's
native counts against its pure-Python DP. Decoded samples are held bit for
bit against JAX's decoder, and against a numpy decode of the same bytes;
a 24-bit and a float file written from known samples read back within one
quantisation step (2**-23, and exactly)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import struct

import numpy as np
import pytest

from speechbrain_tpu.io import native as jax_native
from speechbrain_tpu.utils.edit_distance import (
    accumulatable_wer_stats as jax_wer_stats,
)
from speechbrain_tpu.utils.editdist_native import (
    edit_ops_batch as jax_edit_ops_batch,
)
from speechbrain_tpu_torch.dataio.dataio import (
    read_audio,
    read_audio_info,
    read_audio_multichannel,
    write_audio,
)
from speechbrain_tpu_torch.io import read_wav, read_wav_mono, wav_info
from speechbrain_tpu_torch.utils import host_build
from speechbrain_tpu_torch.utils.edit_distance import (
    accumulatable_wer_stats,
    count_ops,
    op_table,
)
from speechbrain_tpu_torch.utils.editdist_native import edit_ops_batch


def _pairs(seed, n=60, vocab=6, max_len=14):
    rng = np.random.default_rng(seed)
    refs, hyps = [], []
    for _ in range(n):
        ref = rng.integers(0, vocab, rng.integers(0, max_len)).tolist()
        hyp = list(ref)
        for _ in range(rng.integers(0, 5)):  # a few edits of each kind
            kind = rng.integers(0, 3)
            pos = int(rng.integers(0, len(hyp) + 1))
            if kind == 0:
                hyp.insert(pos, int(rng.integers(0, vocab)))
            elif hyp and pos < len(hyp):
                if kind == 1:
                    del hyp[pos]
                else:
                    hyp[pos] = int(rng.integers(0, vocab))
        refs.append(ref)
        hyps.append(hyp)
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_ops_match_jax_and_the_dp(seed):
    refs, hyps = _pairs(seed)
    ours = edit_ops_batch(refs, hyps)
    np.testing.assert_array_equal(ours, jax_edit_ops_batch(refs, hyps))
    for (ref, hyp), row in zip(zip(refs, hyps), ours):
        ops = count_ops(op_table(ref, hyp))
        assert row.tolist() == [ops["insertions"], ops["deletions"],
                                ops["substitutions"]]


def test_edit_ops_take_any_hashable_tokens():
    refs = [["the", "cat", "sat"], [], ["a"]]
    hyps = [["the", "bat"], ["x", "y"], []]
    assert edit_ops_batch(refs, hyps).tolist() == [[0, 1, 1], [2, 0, 0],
                                                   [0, 1, 0]]
    with pytest.raises(ValueError):
        edit_ops_batch(refs, hyps[:2])


def test_wer_stats_match_jax_over_batches():
    stats = jax_stats = None
    for seed in (3, 4):
        refs, hyps = _pairs(seed, n=20)
        stats = accumulatable_wer_stats(refs, hyps, stats)
        jax_stats = jax_wer_stats(refs, hyps, jax_stats)
    assert stats == jax_stats


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "_broken_for_test.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        host_build.build_host_library(src)


def test_libraries_build_into_the_build_dir(tmp_path):
    edit_ops_batch([[1]], [[1]])
    write_audio(tmp_path / "x.wav", np.zeros(8), 8000)
    wav_info(tmp_path / "x.wav")
    for stem in ("_editdist", "_audioio"):
        assert list(host_build.BUILD_DIR.glob(f"lib{stem}_*.so")), stem


# -- WAV --------------------------------------------------------------------

def _write_wav(path, samples, sr, fmt, bits, extensible=False):
    """A RIFF WAV of ``samples`` (frames, channels), already encoded as
    integers (PCM) or float32, written byte by byte."""
    frames, ch = samples.shape
    if fmt == 3:
        data = samples.astype("<f4").tobytes()
    elif bits == 8:
        data = samples.astype(np.uint8).tobytes()
    elif bits == 24:
        v = samples.astype("<i4").reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF],
                        -1).astype(np.uint8).tobytes()
    else:
        data = samples.astype({16: "<i2", 32: "<i4"}[bits]).tobytes()
    block = ch * bits // 8
    if extensible:
        fmt_chunk = struct.pack("<HHIIHHHHI", 0xFFFE, ch, sr, sr * block,
                                block, bits, 22, bits, 0)
        fmt_chunk += struct.pack("<H", fmt) + bytes(14)
    else:
        fmt_chunk = struct.pack("<HHIIHH", fmt, ch, sr, sr * block, block,
                                bits)
    # a LIST chunk of odd size before the data, as some writers add
    extra = b"LIST" + struct.pack("<I", 5) + b"abcde\x00"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk))
            + fmt_chunk + extra + b"data" + struct.pack("<I", len(data))
            + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _encoded(fmt, bits, frames, ch, seed):
    rng = np.random.default_rng(seed)
    if fmt == 3:
        return rng.uniform(-1, 1, (frames, ch)).astype(np.float32)
    if bits == 8:
        return rng.integers(0, 256, (frames, ch))
    hi = 2 ** (bits - 1)
    return rng.integers(-hi, hi, (frames, ch), dtype=np.int64)


def _decoded(fmt, bits, samples):
    if fmt == 3:
        return samples.astype(np.float32)
    if bits == 8:
        return ((samples - 128) / 128.0).astype(np.float32)
    return (samples / float(2 ** (bits - 1))).astype(np.float32)


FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32)]


@pytest.mark.parametrize("fmt,bits", FORMATS)
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax_and_numpy(tmp_path, fmt, bits, channels):
    samples = _encoded(fmt, bits, 257, channels, seed=bits + channels)
    path = tmp_path / "x.wav"
    _write_wav(path, samples, 8000, fmt, bits)
    assert wav_info(path) == jax_native.wav_info(str(path)) == (257, 8000,
                                                              channels)
    for start, stop in ((0, None), (5, 100), (250, 400), (300, None)):
        ours, sr = read_wav(path, start, stop)
        theirs, jsr = jax_native.read_wav(str(path), start, stop)
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(
            ours, _decoded(fmt, bits, samples)[start:stop])
        mono, _ = read_wav_mono(path, start, stop)
        np.testing.assert_array_equal(
            mono, jax_native.read_wav_mono(str(path), start, stop)[0])
        assert sr == jsr == 8000
    np.testing.assert_array_equal(read_audio_multichannel(str(path)),
                                  read_wav(path)[0])
    spec = {"file": str(path), "start": 3, "stop": 9}
    np.testing.assert_array_equal(read_audio(spec),
                                  read_wav_mono(path, 3, 9)[0])


def test_read_audio_is_the_wave_decode_bit_for_bit(tmp_path):
    import wave

    wav = np.sin(np.arange(4000) / 7.0) * 0.7
    path = tmp_path / "s.wav"
    write_audio(path, wav, 16000)
    with wave.open(str(path), "rb") as w:
        ref = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_array_equal(read_audio(str(path)),
                                  ref.astype(np.float32) / 32768.0)
    assert read_audio_info(path) == (4000, 16000, 1)


def test_24_bit_and_float_read_back_within_a_step(tmp_path):
    wav = np.random.default_rng(5).uniform(-0.9, 0.9, (300, 1))
    _write_wav(tmp_path / "p24.wav", np.round(wav * 2 ** 23), 16000, 1, 24)
    _write_wav(tmp_path / "f32.wav", wav.astype(np.float32), 16000, 3, 32)
    assert np.abs(read_audio(str(tmp_path / "p24.wav"))
                  - wav[:, 0]).max() <= 2.0 ** -23
    np.testing.assert_array_equal(read_audio(str(tmp_path / "f32.wav")),
                                  wav[:, 0].astype(np.float32))


def test_extensible_float_is_read_as_float(tmp_path):
    samples = _encoded(3, 32, 64, 2, seed=9)
    _write_wav(tmp_path / "e.wav", samples, 16000, 3, 32, extensible=True)
    np.testing.assert_array_equal(read_wav(tmp_path / "e.wav")[0], samples)


def test_unreadable_files_raise(tmp_path):
    (tmp_path / "g.wav").write_bytes(b"not a riff file at all" * 4)
    with pytest.raises(OSError, match="rc=-2"):
        read_audio(str(tmp_path / "g.wav"))
    with pytest.raises(OSError, match="rc=-1"):
        read_audio(str(tmp_path / "missing.wav"))
    _write_wav(tmp_path / "a.wav", np.zeros((4, 1)), 8000, 6, 8)  # A-law
    with pytest.raises(OSError, match="rc=-4"):
        read_audio(str(tmp_path / "a.wav"))
    with pytest.raises(ValueError, match="flac"):
        read_audio(str(tmp_path / "x.flac"))
