"""LibriMix preparation (reference recipes/LibriMix/prepare_data.py):
indexes mixture/source wavs into JSON manifests, or synthesizes tiny
2-speaker mixtures for --debug runs / recipe tests.

The PyTorch port's twin of ``recipes/LibriMix/separation/prepare.py``:
the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic(data_folder, n_utt=8, sample_rate=8000, seconds=1.0,
                      num_spks=2):
    """``n_utt`` mixtures of ``num_spks`` sines (source s between
    200 + 250 s and 400 + 250 s Hz, amplitude 1 - 0.3 s) as WAV files,
    the last two the valid split; ``train.json`` and ``valid.json`` with
    ``mix_wav``, ``s<i>_wav`` and ``length``. Returns the two paths."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    T = int(sample_rate * seconds)
    entries = {"train": {}, "valid": {}}
    t = np.arange(T) / sample_rate
    for i in range(n_utt):
        srcs = []
        for s in range(num_spks):
            f = rng.uniform(200 + 250 * s, 400 + 250 * s)
            amp = 1.0 - 0.3 * s
            srcs.append(
                (amp * np.sin(2 * np.pi * f * t + s)).astype(np.float32)
            )
        mix = np.sum(srcs, axis=0)
        paths = {}
        for name, sig in [("mix", mix)] + [
            (f"s{s + 1}", srcs[s]) for s in range(num_spks)
        ]:
            p = root / f"u{i}_{name}.wav"
            write_audio(str(p), sig, sample_rate)
            paths[name] = str(p)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"u{i}"] = {
            "mix_wav": paths["mix"], "length": T,
            **{f"s{s + 1}_wav": paths[f"s{s + 1}"]
               for s in range(num_spks)},
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_librimix(data_folder, subset="Libri2Mix", condition="min",
                     sample_rate="wav8k"):
    """Index the official LibriMix folder layout."""
    root = Path(data_folder)
    for split_in, split_out in (("train-100", "train"), ("dev", "valid"),
                                ("test", "test")):
        base = root / subset / sample_rate / condition / split_in
        mixdir = base / "mix_clean"
        if not mixdir.exists():
            continue
        items = {}
        for mix in sorted(mixdir.glob("*.wav")):
            items[mix.stem] = {
                "mix_wav": str(mix),
                "s1_wav": str(base / "s1" / mix.name),
                "s2_wav": str(base / "s2" / mix.name),
                "length": 0,
            }
        with open(root / f"{split_out}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_librimix(folder)
