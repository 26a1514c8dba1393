"""VoxPopuli data preparation on the PyTorch port (the twin of
``recipes/VoxPopuli/ASR/CTC/prepare.py``): the ASR download's tsv files
into JSON manifests, or a synthetic corpus for ``--debug`` runs, the same
manifests and WAV files as the JAX package's."""

import json
import re
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

WORDS = ['parliament', 'europe', 'policy', 'debate', 'union', 'member']


def prepare_synthetic(data_folder, n_utt=10, sample_rate=16000):
    """Write ``n_utt`` utterances of three word tones (0.1 s each) and
    ``train.json``/``valid.json`` (the last two utterances) into
    ``data_folder``; returns the two manifests' paths."""
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


def prepare_voxpopuli(data_folder, lang="en"):
    """Index a VoxPopuli asr download (asr_{train,dev,test}.tsv with
    id, raw_text, normalized_text columns; audio under {lang}/)."""
    import csv as _csv
    root = Path(data_folder)
    for split_in, split_out in (("train", "train"), ("dev", "valid"),
                                ("test", "test")):
        f = root / f"asr_{split_in}.tsv"
        if not f.exists():
            continue
        items = {}
        with open(f, encoding="utf-8") as fh:
            for row in _csv.DictReader(fh, delimiter="\t"):
                utt = row.get("id") or row.get("id_")
                items[utt] = {
                    "wav": str(root / lang / f"{utt}.wav"),
                    "words": (row.get("normalized_text")
                              or row.get("raw_text", "")).lower(),
                    "length": 0,
                }
        with open(root / f"{split_out}.json", "w") as fh:
            json.dump(items, fh, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_voxpopuli(folder)
