"""Switchboard preparation (reference recipes/Switchboard): real-layout
indexer -> JSON manifests, or a synthetic dataset for --debug
runs / recipe tests.

The PyTorch port's twin of
``recipes/Switchboard/ASR/CTC/prepare.py``: the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

WORDS = ['yeah', 'right', 'uh', 'huh', 'really', 'okay']


def prepare_synthetic(data_folder, n_utt=10, sample_rate=16000):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = {"train": {}, "valid": {}}
    for i in range(n_utt):
        # cyclic word choice: every word (hence every character) appears
        # in the train split, so the valid split has no OOV characters
        words = [(i + j) % len(WORDS) for j in range(3)]
        sig = np.concatenate([
            np.sin(2 * np.pi * (220 + 90 * w) * np.arange(1600) / sample_rate)
            for w in words
        ]).astype(np.float32)
        path = root / f"talk{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"talk{i}"] = {
            "wav": str(path),
            "words": " ".join(WORDS[w] for w in words),
            "length": len(sig),
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_switchboard(data_folder):
    """Index a Switchboard layout: expects per-split CSVs
    ({train,dev,test}.csv with columns id,wav,start,stop,words) as
    produced by the usual Kaldi-style preparation (the LDC release's
    sph files must be converted to wav beforehand)."""
    import csv as _csv
    root = Path(data_folder)
    for split_in, split_out in (("train", "train"), ("dev", "valid"),
                                ("test", "test")):
        f = root / f"{split_in}.csv"
        if not f.exists():
            continue
        items = {}
        with open(f, encoding="utf-8") as fh:
            for row in _csv.DictReader(fh):
                items[row["id"]] = {
                    "wav": row["wav"],
                    "start": float(row.get("start", 0) or 0),
                    "stop": float(row.get("stop", 0) or 0),
                    "words": row["words"].lower(), "length": 0,
                }
        with open(root / f"{split_out}.json", "w") as fh:
            json.dump(items, fh, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_switchboard(folder)
