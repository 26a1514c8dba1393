"""Fused log-mel front end (port of ``speechbrain_tpu/ops/mel_frontend.py``).

Replaces the STFT -> |.|^2 -> mel -> dB chain by ONE hand-written CUDA
kernel (``csrc/mel_frontend.cu``): a block takes a tile of frames of one
utterance, frames its span of the waveform in shared memory, transforms it
with a window-folded real DFT, squares, mel-projects and log-compresses —
no frames or power-spectrum intermediates reach device memory.

The per-sequence top_db clamp needs a maximum over all frames, so it is
applied outside, on the (small) output. ``fused_fbank_reference`` repeats
the kernel's arithmetic in plain PyTorch; the wrapper takes it only for
tensors that lie on the CPU.
"""

import math

import numpy as np
import torch

from speechbrain_tpu_torch.ops._build import load_library

# number of kernel launches made by this process (the plain version does
# not count); ``chip_smoke.py`` zeroes and reads it
launches = 0


def dft_tables(window, n_fft):
    """Window-folded real-DFT matrices ``(cos, sin)``, each
    ``(n_fft, n_freq)`` float32 on the window's device. The angles are
    made in float64 and cast, then the window is folded in in float32."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    w = window.to(torch.float32)[:, None]
    cos_m = torch.from_numpy(np.cos(ang).astype(np.float32)).to(w.device) * w
    sin_m = torch.from_numpy((-np.sin(ang)).astype(np.float32)).to(w.device) * w
    return cos_m.contiguous(), sin_m.contiguous()


def _n_frames(T, n_fft, hop_length):
    return 1 + (T + 2 * (n_fft // 2) - n_fft) // hop_length


def fused_fbank_reference(wav, cos_m, sin_m, fbank_matrix, n_fft, hop_length,
                          multiplier, amin, db_offset):
    """Plain PyTorch version of the kernel: (B, T) -> (B, n_frames,
    n_mels) log-mel in dB, before the top_db clamp."""
    half = n_fft // 2
    padded = torch.nn.functional.pad(wav, (half, half))
    frames = padded.unfold(-1, n_fft, hop_length)  # (B, n_frames, n_fft)
    real = torch.matmul(frames, cos_m)
    imag = torch.matmul(frames, sin_m)
    power = real * real + imag * imag
    mel = torch.matmul(power, fbank_matrix)
    return multiplier * torch.log10(torch.clamp(mel, min=amin)) - db_offset


def _fused_fbank_cuda(wav, cos_m, sin_m, fbank_matrix, n_fft, hop_length,
                      multiplier, amin, db_offset):
    """Launch ``csrc/mel_frontend.cu`` on PyTorch's current stream."""
    global launches
    n_freq = n_fft // 2 + 1
    if wav.ndim != 2:
        raise ValueError("wav must be (batch, time)")
    B, T = wav.shape
    n_mels = fbank_matrix.shape[1]
    for name, t, shape in (
        ("wav", wav, (B, T)),
        ("cos table", cos_m, (n_fft, n_freq)),
        ("sin table", sin_m, (n_fft, n_freq)),
        ("fbank_matrix", fbank_matrix, (n_freq, n_mels)),
    ):
        if not t.is_cuda or t.device != wav.device:
            raise ValueError(f"{name} must lie on the waveform's CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_frames = _n_frames(T, n_fft, hop_length)
    lib = load_library()
    out = torch.empty(
        (B, n_frames, n_mels), device=wav.device, dtype=torch.float32
    )
    with torch.cuda.device(wav.device):
        err = lib.sb_fused_fbank(
            wav.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
            fbank_matrix.data_ptr(), out.data_ptr(), B, T, n_frames, n_fft,
            n_freq, n_mels, hop_length, amin, multiplier, db_offset,
            torch.cuda.current_stream(wav.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused fbank kernel launch failed (code {err})")
    launches += 1
    return out


def fused_fbank(wav, window, fbank_matrix, n_fft=400, hop_length=160,
                top_db=80.0, multiplier=10.0, amin=1e-10, ref_value=1.0,
                tables=None):
    """Log-mel filterbanks (B, n_frames, n_mels) from (B, T) waveforms.

    Numerically matches ``lobes.features.Fbank``'s unfused path (centred
    framing, window folded into the DFT, power spectrum, mel projection,
    10*log10 with amin + per-sequence top_db clamp). ``tables`` takes the
    result of :func:`dft_tables` from a caller that keeps it; otherwise
    the tables are made on every call.

    A CUDA waveform goes to the hand-written kernel, or the call raises;
    a CPU waveform goes to :func:`fused_fbank_reference`.
    """
    cos_m, sin_m = tables if tables is not None else dft_tables(window, n_fft)
    db_offset = multiplier * math.log10(max(amin, ref_value))
    impl = _fused_fbank_cuda if wav.is_cuda else fused_fbank_reference
    out = impl(
        wav, cos_m, sin_m, fbank_matrix, n_fft, hop_length, multiplier,
        amin, db_offset,
    )
    # per-sequence top_db clamp (global max -> outside the kernel)
    maxes = torch.amax(out, dim=(1, 2), keepdim=True)
    return torch.maximum(out, maxes - top_db)
