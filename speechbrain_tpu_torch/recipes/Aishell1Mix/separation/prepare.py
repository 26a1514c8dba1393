"""Aishell1Mix preparation (reference recipes/Aishell1Mix/prepare_data.py):
indexes mixture/source wavs into JSON manifests, or synthesizes tiny
2-speaker mixtures for --debug runs / recipe tests.

The PyTorch port's twin of ``recipes/Aishell1Mix/separation/prepare.py``:
the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.recipes.LibriMix.separation.prepare import (
    prepare_librimix,
)


def prepare_synthetic(data_folder, n_utt=8, sample_rate=8000, seconds=1.0,
                      num_spks=2, wham_noise=False):
    """``n_utt`` mixtures of ``num_spks`` sources (even-numbered ones
    sines at 1.0, odd-numbered ones square waves at 0.6), with white
    noise at 0.1 where ``wham_noise``; the last two the valid split."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    T = int(sample_rate * seconds)
    entries = {"train": {}, "valid": {}}
    t = np.arange(T) / sample_rate
    for i in range(n_utt):
        srcs = []
        for k in range(num_spks):
            f = rng.uniform(200 + 250 * k, 400 + 250 * k)
            amp = 1.0 if k % 2 == 0 else 0.6
            wave = np.sin(2 * np.pi * f * t)
            if k % 2:  # square-ish for spectral contrast
                wave = np.sign(wave)
            srcs.append((amp * wave).astype(np.float32))
        mix = np.sum(srcs, axis=0)
        if wham_noise:
            mix = mix + 0.1 * rng.standard_normal(T).astype(np.float32)
        paths = {}
        named = [("mix", mix)] + [
            (f"s{k + 1}", s) for k, s in enumerate(srcs)
        ]
        for name, sig in named:
            p = root / f"u{i}_{name}.wav"
            write_audio(str(p), sig.astype(np.float32), sample_rate)
            paths[name] = str(p)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"u{i}"] = {
            **{f"{n}_wav": p for n, p in paths.items()}, "length": T,
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_librimix(folder)
