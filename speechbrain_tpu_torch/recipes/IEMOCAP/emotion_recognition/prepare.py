"""IEMOCAP preparation (reference recipes/IEMOCAP/iemocap_prepare.py):
session-wise JSON manifests with emotion labels, or a synthetic
emotion-tone dataset for --debug runs / recipe tests.

The PyTorch port's twin of
``recipes/IEMOCAP/emotion_recognition/prepare.py``:
the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

EMOTIONS = ["neu", "hap", "sad", "ang"]


def prepare_synthetic(data_folder, n_per_class=3, sample_rate=16000):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = {"train": {}, "valid": {}}
    t = np.arange(sample_rate) / sample_rate
    for ei, emo in enumerate(EMOTIONS):
        for i in range(n_per_class):
            # emotion -> distinctive modulation rate
            carrier = np.sin(2 * np.pi * 220 * t)
            mod = 1 + 0.8 * np.sin(2 * np.pi * (2 + 3 * ei) * t)
            sig = (carrier * mod * 0.5).astype(np.float32)
            sig += 0.02 * rng.standard_normal(len(sig)).astype(np.float32)
            path = root / f"{emo}_{i}.wav"
            write_audio(str(path), sig, sample_rate)
            split = "valid" if i == n_per_class - 1 else "train"
            entries[split][f"{emo}_{i}"] = {
                "wav": str(path), "emo": emo, "length": len(sig),
            }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_iemocap(data_folder, test_session=5):
    """Index the IEMOCAP release layout (Session*/sentences/wav +
    EmoEvaluation labels); leave-one-session-out split."""
    root = Path(data_folder)
    entries = {"train": {}, "valid": {}}
    for sess_dir in sorted(root.glob("Session*")):
        sess = int(sess_dir.name[-1])
        labdir = sess_dir / "dialog" / "EmoEvaluation"
        labels = {}
        for f in labdir.glob("*.txt"):
            for line in f.read_text(errors="ignore").splitlines():
                if line.startswith("["):
                    parts = line.split("\t")
                    if len(parts) >= 3 and parts[2] in (
                        "neu", "hap", "sad", "ang", "exc"
                    ):
                        labels[parts[1]] = (
                            "hap" if parts[2] == "exc" else parts[2]
                        )
        split = "valid" if sess == test_session else "train"
        for wav in (sess_dir / "sentences" / "wav").rglob("*.wav"):
            if wav.stem in labels:
                entries[split][wav.stem] = {
                    "wav": str(wav), "emo": labels[wav.stem], "length": 0,
                }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_iemocap(folder)
