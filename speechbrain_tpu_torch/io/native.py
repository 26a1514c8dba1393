"""ctypes binding of the native WAV decoder (port of
``speechbrain_tpu/io/native.py``).

``_audioio.cpp`` is built with ``g++`` at first use into
``speechbrain_tpu_torch/_build/`` (``utils/host_build.py``). It reads
RIFF WAV: unsigned 8-bit and signed 16/24/32-bit PCM and IEEE float32,
any number of channels, a ``[start, stop)`` frame segment. A decode
releases the GIL, so the loader's read-ahead threads decode in parallel.
A file whose header cannot be parsed raises ``OSError``; a failed build
raises ``RuntimeError``. Nothing falls back to the ``wave`` module.
"""

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.utils.host_build import load_host_library

SOURCE = Path(__file__).resolve().parent / "_audioio.cpp"

_ERRORS = {
    -1: "cannot open the file",
    -2: "no RIFF/WAVE header with a fmt and a data chunk",
    -3: "the output buffer is too small",
    -4: "a sample format the decoder does not read (PCM 8/16/24/32-bit "
        "and IEEE float32 are read)",
}


@functools.lru_cache(maxsize=None)
def load_library():
    """The decoder as a ``ctypes.CDLL`` (built on first call)."""
    lib = load_host_library(SOURCE)
    lib.sbtpu_wav_info.restype = ctypes.c_int
    lib.sbtpu_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    for fn in (lib.sbtpu_wav_decode, lib.sbtpu_wav_decode_mono):
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
    return lib


def _fail(path, what, rc):
    raise OSError(f"{path}: {what} failed, {_ERRORS.get(rc, 'error')} "
                  f"(rc={rc})")


def wav_info(path):
    """``(frames, sample_rate, channels)`` from the header alone."""
    frames, sr, ch = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
    rc = load_library().sbtpu_wav_info(
        os.fsencode(path), ctypes.byref(frames), ctypes.byref(sr),
        ctypes.byref(ch),
    )
    if rc != 0:
        _fail(path, "reading the WAV header", rc)
    return frames.value, sr.value, ch.value


def _segment(path, start, stop):
    frames, sr, ch = wav_info(path)
    start = max(int(start), 0)
    stop = frames if stop is None else min(int(stop), frames)
    return start, stop, max(stop - start, 0), sr, ch


def read_wav(path, start=0, stop=None):
    """Frames ``[start, stop)`` as float32 ``(frames, channels)`` and the
    sample rate."""
    start, stop, n, sr, ch = _segment(path, start, stop)
    out = np.empty(n * ch, np.float32)
    got = load_library().sbtpu_wav_decode(
        os.fsencode(path), start, stop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
    )
    if got < 0:
        _fail(path, "decoding", got)
    return out[: got * ch].reshape(got, ch), sr


def read_wav_mono(path, start=0, stop=None):
    """Frames ``[start, stop)`` averaged over the channels in one pass:
    float32 ``(frames,)`` and the sample rate."""
    start, stop, n, sr, _ = _segment(path, start, stop)
    out = np.empty(n, np.float32)
    got = load_library().sbtpu_wav_decode_mono(
        os.fsencode(path), start, stop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
    )
    if got < 0:
        _fail(path, "decoding", got)
    return out[:got], sr
