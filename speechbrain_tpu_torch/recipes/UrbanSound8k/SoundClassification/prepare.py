"""UrbanSound8k preparation (reference
recipes/UrbanSound8k/urbansound8k_prepare.py):
metadata/UrbanSound8K.csv -> JSON manifests with fold-wise split, or
synthetic sound-class tones for --debug runs / recipe tests.

The PyTorch port's twin of
``recipes/UrbanSound8k/SoundClassification/prepare.py``:
the same files and manifests."""

import csv
import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

CLASSES = ["dog_bark", "drilling", "siren", "children_playing"]


def prepare_synthetic(data_folder, n_per_class=3, sample_rate=16000):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    t = np.arange(sample_rate) / sample_rate
    entries = {"train": {}, "valid": {}}
    for ci, cls in enumerate(CLASSES):
        for i in range(n_per_class):
            sig = (
                np.sign(np.sin(2 * np.pi * (100 + 200 * ci) * t))
                * np.exp(-3 * ((t * (ci + 1)) % 1.0))
            ).astype(np.float32) * 0.4
            sig += 0.02 * rng.standard_normal(len(sig)).astype(np.float32)
            path = root / f"{cls}_{i}.wav"
            write_audio(str(path), sig, sample_rate)
            split = "valid" if i == n_per_class - 1 else "train"
            entries[split][f"{cls}_{i}"] = {
                "wav": str(path), "class_name": cls, "length": len(sig),
            }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_urbansound8k(data_folder, valid_fold=10):
    """Index the official UrbanSound8K layout (audio/fold{N}/ +
    metadata/UrbanSound8K.csv)."""
    root = Path(data_folder)
    entries = {"train": {}, "valid": {}}
    with open(root / "metadata" / "UrbanSound8K.csv") as f:
        for row in csv.DictReader(f):
            split = "valid" if int(row["fold"]) == valid_fold else "train"
            entries[split][row["slice_file_name"]] = {
                "wav": str(root / "audio" / f"fold{row['fold']}"
                           / row["slice_file_name"]),
                "class_name": row["class"],
                "length": 0,
            }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_urbansound8k(folder)
