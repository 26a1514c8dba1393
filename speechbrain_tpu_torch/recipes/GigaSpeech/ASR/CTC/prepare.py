"""GigaSpeech data preparation on the PyTorch port (the twin of
``recipes/GigaSpeech/ASR/CTC/prepare.py``): the release's
``GigaSpeech.json`` into JSON manifests, or a synthetic corpus for
``--debug`` runs, the same manifests and WAV files as the JAX package's."""

import json
import re
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

WORDS = ['news', 'podcast', 'audio', 'book', 'show', 'episode']


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


def prepare_gigaspeech(data_folder, subset="XS"):
    """Index a GigaSpeech release from its GigaSpeech.json metadata:
    each audio document carries `segments` with [begin_time, end_time,
    text_tn]; punctuation tags (<COMMA> etc.) are stripped."""
    root = Path(data_folder)
    meta = root / "GigaSpeech.json"
    with open(meta, encoding="utf-8") as fh:
        corpus = json.load(fh)
    splits = {"train": {}, "valid": {}, "test": {}}
    tagmap = {"{TRAIN}": "train", "{DEV}": "valid", "{TEST}": "test"}
    for doc in corpus.get("audios", []):
        for seg in doc.get("segments", []):
            subsets = seg.get("subsets", [])
            split = next((v for k, v in tagmap.items() if k in subsets),
                         None)
            if split is None or ("{%s}" % subset) not in subsets:
                continue
            words = re.sub(r"<[A-Z]+>", "", seg["text_tn"]).strip().lower()
            splits[split][seg["sid"]] = {
                "wav": str(root / doc["path"]),
                "start": float(seg["begin_time"]),
                "stop": float(seg["end_time"]),
                "words": words, "length": 0,
            }
    for split, items in splits.items():
        with open(root / f"{split}.json", "w") as fh:
            json.dump(items, fh, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_gigaspeech(folder)
