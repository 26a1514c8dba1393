"""CommonVoice data preparation on the PyTorch port (the twin of
``recipes/CommonVoice/commonvoice_prepare.py``): the release's tsv files
into JSON manifests with ``wav``/``words`` entries, or a synthetic tone
corpus for ``--debug`` runs. The same seed gives the same manifests and
WAV files as the JAX package's."""

import csv
import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

WORDS = ["uno", "dos", "tres", "quatre", "cinq", "sechs", "sept", "okto"]


def prepare_synthetic(data_folder, save_folder=None, n_utts=12,
                      sample_rate=16000, seed=0):
    """Tiny synthetic corpus with CommonVoice-shaped manifests
    (train/dev/test.json in data_folder): each word maps to a tone."""
    save_folder = save_folder or data_folder
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    Path(save_folder).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "dev": {}, "test": {}}
    for i in range(n_utts):
        idx = rng.integers(0, len(WORDS), size=int(rng.integers(2, 5)))
        words = " ".join(WORDS[j] for j in idx)
        segs = []
        for j in idx:
            t = np.arange(int(0.12 * sample_rate)) / sample_rate
            segs.append(np.sin(2 * np.pi * (300 + 80 * j) * t))
        sig = np.concatenate(segs).astype(np.float32) * 0.5
        sig += 0.01 * rng.standard_normal(len(sig)).astype(np.float32)
        path = root / f"cv_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = ("dev" if i % 6 == 4 else "test" if i % 6 == 5 else "train")
        manifests[split][f"cv_{i}"] = {
            "wav": str(path),
            "words": words,
            "spk_id": f"spk{i % 3}",
            "length": len(sig) / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(Path(save_folder) / f"{split}.json", "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def prepare_common_voice(data_folder, save_folder=None, language="en"):
    """Index the official CommonVoice tsv layout into JSON manifests."""
    root = Path(data_folder)
    save_folder = Path(save_folder or data_folder)
    for split_in, split_out in (("train", "train"), ("dev", "dev"),
                                ("test", "test")):
        tsv = root / f"{split_in}.tsv"
        if not tsv.exists():
            continue
        items = {}
        with open(tsv, encoding="utf-8") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                clip = root / "clips" / row["path"]
                items[row["path"]] = {
                    "wav": str(clip),
                    "words": row["sentence"].lower(),
                    "spk_id": row.get("client_id", "unk"),
                    "length": 0,
                }
        with open(save_folder / f"{split_out}.json", "w",
                  encoding="utf-8") as f:
            json.dump(items, f, ensure_ascii=False, indent=1)


if __name__ == "__main__":
    folder = sys.argv[1]
    if "--synthetic" in sys.argv:
        prepare_synthetic(folder)
    else:
        prepare_common_voice(folder)
