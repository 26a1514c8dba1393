"""DVoice preparation on the PyTorch port (the twin of
``recipes/DVoice/ASR/CTC/prepare.py``): a DVoice release's CSVs indexed into
JSON manifests (:func:`prepare_dvoice`), or a synthetic corpus for
``--debug`` runs and the tests (:func:`prepare_synthetic`, the JAX script's
byte for byte)."""

import json
import sys
from pathlib import Path

import numpy as np

WORDS = ['darija', 'swahili', 'wolof', 'amharic', 'fongbe', 'audio']


def prepare_synthetic(data_folder, n_utt=10, sample_rate=16000):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    from speechbrain_tpu_torch.dataio.dataio import write_audio

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


def prepare_dvoice(data_folder):
    """Index a DVoice release ({train,dev,test}.csv with wav_path and
    words columns; semicolon-separated like CommonVoice exports)."""
    import csv as _csv
    root = Path(data_folder)
    for split_in, split_out in (("train", "train"), ("dev", "valid"),
                                ("test", "test")):
        f = root / f"{split_in}.csv"
        if not f.exists():
            continue
        items = {}
        with open(f, encoding="utf-8") as fh:
            sample = fh.read(4096); fh.seek(0)
            delim = ";" if sample.count(";") > sample.count(",") else ","
            for i, row in enumerate(_csv.DictReader(fh, delimiter=delim)):
                wav = row.get("wav_path") or row.get("path") or row.get("wav")
                text = row.get("words") or row.get("sentence") or ""
                items[f"{split_in}_{i}"] = {
                    "wav": str(root / wav), "words": text.lower(),
                    "length": 0,
                }
        with open(root / f"{split_out}.json", "w") as fh:
            json.dump(items, fh, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_dvoice(folder)
