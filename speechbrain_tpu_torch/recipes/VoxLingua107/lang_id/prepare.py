"""VoxLingua107 preparation: per-language folders (107 languages in the
full release) -> JSON manifests, or synthetic language-tone data for
--debug runs.

The PyTorch port's twin of
``recipes/VoxLingua107/lang_id/prepare.py``: the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

LANGS = ["en", "fr", "de", "es", "ru", "zh"]


def prepare_synthetic(data_folder, n_per_lang=3, sample_rate=16000):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = {"train": {}, "valid": {}}
    t = np.arange(sample_rate) / sample_rate
    for li, lang in enumerate(LANGS):
        for i in range(n_per_lang):
            sig = (
                np.sin(2 * np.pi * (150 + 100 * li) * t)
                * (1 + 0.5 * np.sin(2 * np.pi * (3 + li) * t))
            ).astype(np.float32) * 0.5
            sig += 0.02 * rng.standard_normal(len(sig)).astype(np.float32)
            path = root / f"{lang}_{i}.wav"
            write_audio(str(path), sig, sample_rate)
            split = "valid" if i == n_per_lang - 1 else "train"
            entries[split][f"{lang}_{i}"] = {
                "wav": str(path), "language": lang, "length": len(sig),
            }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_voxlingua107(data_folder):
    """Index the VoxLingua107 layout (<language>/*.wav per language
    dir); 9:1 train/valid split per language."""
    root = Path(data_folder)
    items = {"train": {}, "valid": {}}
    for lang_dir in sorted(d for d in root.iterdir() if d.is_dir()):
        wavs = sorted(lang_dir.glob("*.wav"))
        for i, wav in enumerate(wavs):
            split = "valid" if i % 10 == 9 else "train"
            items[split][f"{lang_dir.name}_{wav.stem}"] = {
                "wav": str(wav), "language": lang_dir.name, "length": 0,
            }
    for split, data in items.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(data, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_voxlingua107(folder)
