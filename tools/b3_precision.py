"""How precise each arithmetic scheme for the fused log-mel DFT is: a CPU
emulation in numpy (kernel B3, ``speechbrain_tpu_torch/csrc/mel_frontend.cu``).

    python3 tools/b3_precision.py

For 2 s at 16 kHz of each check signal of
``speechbrain_tpu_torch.utils.signals.make_check_signal`` (white noise, the
chirp with noise 60 and 80 dB below it, noise bursts with digital
silence), the log-mel of the port's ``Fbank`` (n_fft 400, hop 160,
80 mels, top_db 80) is computed with the DFT's operands in each scheme and
compared with float64 throughout; the largest difference in dB is printed:

- ``fp32``: frames and tables in float32, a float32 product (numpy's);
- ``tf32x1``: both operands rounded to TF32 (10 mantissa bits), one pass;
- ``bf16x3``: each operand split into bfloat16 hi and lo (7 mantissa bits),
  hi hi + hi lo + lo hi;
- ``tf32x3``: the same split into TF32 parts (the kernel's scheme).

Products and sums of the emulated schemes are in float64, so the figures
show what the rounding of the operands costs, not the order of any sum on a
card. Then the mel projection alone, with the DFT exact: its operands in
one TF32 or bfloat16 pass. One JSON object a line; CPU only.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from speechbrain_tpu_torch.utils.signals import make_check_signal  # noqa: E402
from speechbrain_tpu_torch.lobes.features import Fbank  # noqa: E402
from speechbrain_tpu_torch.ops.mel_frontend import tf32_round  # noqa: E402

N_FFT, HOP = 400, 160


def bf16_round(x):
    """float32 ``x`` rounded to bfloat16, to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return ((u + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def split(x, rnd):
    hi = rnd(x)
    return hi.astype(np.float64), rnd(x - hi).astype(np.float64)


def db(power, mel):
    out = 10.0 * np.log10(np.maximum(power @ mel, 1e-10))
    return np.maximum(out, out.max() - 80.0)


def main():
    fbank = Fbank(n_mels=80, fused=True, device="cpu")
    cos_m, sin_m = (t.numpy() for t in fbank._tables)
    mel = fbank.compute_fbanks.fbank_matrix.numpy()
    table = np.concatenate([cos_m, sin_m], axis=1)  # (n_fft, 2 n_freq)
    n_freq = cos_m.shape[1]
    signals = [("noise", {}), ("chirp", {"noise_db": 60.0}),
               ("chirp", {"noise_db": 80.0}), ("bursts", {})]
    for kind, kw in signals:
        wav = make_check_signal(kind, 1, 2 * 16000, seed=0, **kw)[0]
        padded = np.pad(wav, (N_FFT // 2, N_FFT // 2))
        n_frames = 1 + len(wav) // HOP
        idx = np.arange(n_frames)[:, None] * HOP + np.arange(N_FFT)
        frames = padded[idx]

        def power(prod):
            return prod[:, :n_freq] ** 2 + prod[:, n_freq:] ** 2

        exact_power = power(frames.astype(np.float64) @ table)
        ref = db(exact_power, mel.astype(np.float64))
        prods = {
            "fp32": (frames @ table).astype(np.float64),
            "tf32x1": (tf32_round(frames).astype(np.float64)
                       @ tf32_round(table).astype(np.float64)),
        }
        for name, rnd in (("bf16x3", bf16_round), ("tf32x3", tf32_round)):
            fh, fl = split(frames, rnd)
            th, tl = split(table, rnd)
            prods[name] = fh @ th + fh @ tl + fl @ th
        row = {"signal": kind, **kw}
        for name, prod in prods.items():
            row[name] = float(np.abs(db(power(prod), mel) - ref).max())
        p32 = exact_power.astype(np.float32)
        for name, rnd in (("mel_tf32x1", tf32_round),
                          ("mel_bf16x1", bf16_round)):
            out = db(rnd(p32).astype(np.float64),
                     rnd(mel).astype(np.float64))
            row[name] = float(np.abs(out - ref).max())
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
