"""Fused log-mel front end (port of ``speechbrain_tpu/ops/mel_frontend.py``).

Replaces the STFT -> |.|^2 -> mel -> dB chain by ONE hand-written CUDA
kernel (``csrc/mel_frontend.cu``): a block takes up to 64 frames of one
utterance, frames their span of the waveform in shared memory, transforms
it with a window-folded real DFT on the tensor cores (TF32 split in three
passes, float32's precision), squares, mel-projects over each filter's
non-zero bins and log-compresses — no frames or power-spectrum
intermediates reach device memory.

The kernel reads its tables in a layout of its own, made once by
:func:`kernel_operands` (``Fbank`` caches it). The per-sequence top_db
clamp needs a maximum over all frames, so it is applied outside, on the
(small) output. ``fused_fbank_reference`` repeats the kernel's arithmetic
in plain float32 PyTorch; the wrapper takes it only for tensors that lie
on the CPU.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from speechbrain_tpu_torch.ops import refuse_autograd
from speechbrain_tpu_torch.ops._build import load_library

# number of kernel launches made by this process (the plain version does
# not count); ``chip_smoke.py`` zeroes and reads it
launches = 0

# The kernel's tiles (csrc/mel_frontend.cu): a table tile is TILE_COLS
# interleaved cos/sin columns (wgmma's N) by TILE_K samples (one 128-byte
# row of TF32), in hi and lo parts.
TILE_COLS = 208
TILE_K = 32


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


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: a numpy float32
    array."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class KernelOperands(NamedTuple):
    """The kernel's tables and mel filters, made by :func:`kernel_operands`.

    - ``tables``: float32, flat. Tile ``(c, kt)`` holds table columns
      ``[c * TILE_COLS, + TILE_COLS)`` (column ``2 k`` is the cos of
      frequency ``k``, ``2 k + 1`` its sin) by samples ``[kt * TILE_K, +
      TILE_K)``, stored at ``(c * n_ktiles + kt) * 2 * TILE_COLS * TILE_K``
      as its hi part (the table rounded to TF32), then its lo part (the
      rest rounded to TF32), each as ``TILE_COLS`` rows of ``TILE_K``
      samples in wgmma's 128-byte swizzle: sample ``e`` of row ``r`` at
      ``r * 32 + ((e // 4) ^ (r % 8)) * 4 + e % 4``. Columns past
      ``2 n_freq`` and samples past ``n_fft`` are zeros.
    - ``mel_ranges``: int32 ``(n_mels, 2)``, each filter's first non-zero
      bin and one past its last (``0, 0`` for a filter of zeros).
    - ``mel_weights``: float32 ``(n_mels, mel_width)``, filter ``m``'s
      weights from its first non-zero bin on, zero-padded.
    """

    tables: torch.Tensor
    mel_ranges: torch.Tensor
    mel_weights: torch.Tensor
    n_chunks: int
    n_ktiles: int


def kernel_operands(cos_m, sin_m, fbank_matrix):
    """The kernel's operand layout (:class:`KernelOperands`) from the
    tables of :func:`dft_tables` and the ``(n_freq, n_mels)`` mel matrix,
    on their device. Made on the host, once for a caller that keeps it."""
    device = cos_m.device
    cos_np = cos_m.detach().cpu().numpy().astype(np.float32)
    sin_np = sin_m.detach().cpu().numpy().astype(np.float32)
    n_fft, n_freq = cos_np.shape
    n_chunks = -(-2 * n_freq // TILE_COLS)
    n_ktiles = -(-n_fft // TILE_K)
    inter = np.zeros((n_ktiles * TILE_K, n_chunks * TILE_COLS), np.float32)
    inter[:n_fft, 0:2 * n_freq:2] = cos_np
    inter[:n_fft, 1:2 * n_freq:2] = sin_np
    hi = tf32_round(inter)
    lo = tf32_round(inter - hi)
    # (part, kt, e, c, r) -> (c, kt, part, r, e): K-major tiles
    parts = np.stack([hi, lo]).reshape(
        2, n_ktiles, TILE_K, n_chunks, TILE_COLS
    ).transpose(3, 1, 0, 4, 2)
    r = np.arange(TILE_COLS)[:, None]
    e = np.arange(TILE_K)[None, :]
    dest = np.broadcast_to(((e // 4) ^ (r % 8)) * 4 + e % 4, parts.shape)
    swizzled = np.empty_like(parts)
    np.put_along_axis(swizzled, dest, parts, axis=-1)

    mel = fbank_matrix.detach().cpu().numpy().astype(np.float32)
    n_mels = mel.shape[1]
    ranges = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            ranges[m] = nz[0], nz[-1] + 1
    width = max(1, int((ranges[:, 1] - ranges[:, 0]).max()))
    weights = np.zeros((n_mels, width), np.float32)
    for m, (first, stop) in enumerate(ranges):
        weights[m, :stop - first] = mel[first:stop, m]
    return KernelOperands(
        tables=torch.from_numpy(swizzled.reshape(-1)).to(device),
        mel_ranges=torch.from_numpy(ranges).to(device),
        mel_weights=torch.from_numpy(weights).to(device),
        n_chunks=n_chunks, n_ktiles=n_ktiles,
    )


def span_skew(hop_length):
    """Unused words the kernel leaves after every ``hop_length`` samples of
    its span, so that a frame's stride ``hop_length + skew`` is 4 (mod 8):
    the 8 frames x 4 samples of a fragment load then fall on 32 banks."""
    return (4 - hop_length) % 8


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
                      multiplier, amin, db_offset, operands=None):
    """Launch ``csrc/mel_frontend.cu`` on PyTorch's current stream; its
    operands are ``operands`` (:func:`kernel_operands` of these tables and
    matrix), or are made here."""
    global launches
    refuse_autograd(
        "fused_fbank_reference", wav, cos_m, sin_m, fbank_matrix
    )
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
    if not wav.is_contiguous():
        raise ValueError("wav must be contiguous")
    if operands is None:
        operands = kernel_operands(cos_m, sin_m, fbank_matrix)
    tables, ranges, weights, n_chunks, n_ktiles = operands
    if (n_chunks * TILE_COLS < 2 * n_freq or n_ktiles * TILE_K < n_fft
            or tables.numel() != n_chunks * n_ktiles * 2 * TILE_COLS * TILE_K
            or tuple(ranges.shape) != (n_mels, 2)
            or weights.ndim != 2 or weights.shape[0] != n_mels):
        raise ValueError("operands do not match these tables and mel matrix")
    for name, t, dtype in (("tables", tables, torch.float32),
                           ("mel_ranges", ranges, torch.int32),
                           ("mel_weights", weights, torch.float32)):
        if t.device != wav.device or t.dtype != dtype:
            raise ValueError(
                f"operands.{name} must be {dtype} on the waveform's device"
            )
        if not t.is_contiguous():
            raise ValueError(f"operands.{name} must be contiguous")
    n_frames = _n_frames(T, n_fft, hop_length)
    lib = load_library()
    out = torch.empty(
        (B, n_frames, n_mels), device=wav.device, dtype=torch.float32
    )
    with torch.cuda.device(wav.device):
        err = lib.sb_fused_fbank(
            wav.data_ptr(), tables.data_ptr(), ranges.data_ptr(),
            weights.data_ptr(), out.data_ptr(), B, T, n_frames, n_fft,
            n_freq, n_mels, weights.shape[1], hop_length,
            span_skew(hop_length), n_chunks, n_ktiles, amin, multiplier,
            db_offset,
            torch.cuda.current_stream(wav.device).cuda_stream,
        )
    if err == -2:
        raise ValueError(
            f"fused fbank kernel: n_fft {n_fft} and {n_mels} mel filters "
            f"{weights.shape[1]} bins wide do not fit a block's shared memory"
        )
    if err != 0:
        raise RuntimeError(f"fused fbank kernel launch failed (code {err})")
    launches += 1
    return out


def fused_fbank(wav, window, fbank_matrix, n_fft=400, hop_length=160,
                top_db=80.0, multiplier=10.0, amin=1e-10, ref_value=1.0,
                tables=None, operands=None):
    """Log-mel filterbanks (B, n_frames, n_mels) from (B, T) waveforms.

    Numerically matches ``lobes.features.Fbank``'s unfused path (centred
    framing, window folded into the DFT, power spectrum, mel projection,
    10*log10 with amin + per-sequence top_db clamp). ``tables`` takes the
    result of :func:`dft_tables` from a caller that keeps it; otherwise
    the tables are made on every call. ``operands`` takes the kernel's
    layout of them (:func:`kernel_operands`) likewise.

    A CUDA waveform goes to the hand-written kernel, or the call raises;
    a CPU waveform goes to :func:`fused_fbank_reference`.
    """
    cos_m, sin_m = tables if tables is not None else dft_tables(window, n_fft)
    db_offset = multiplier * math.log10(max(amin, ref_value))
    args = (wav, cos_m, sin_m, fbank_matrix, n_fft, hop_length, multiplier,
            amin, db_offset)
    if wav.is_cuda:
        out = _fused_fbank_cuda(*args, operands=operands)
    else:
        out = fused_fbank_reference(*args)
    # per-sequence top_db clamp (global max -> outside the kernel)
    maxes = torch.amax(out, dim=(1, 2), keepdim=True)
    return torch.maximum(out, maxes - top_db)
