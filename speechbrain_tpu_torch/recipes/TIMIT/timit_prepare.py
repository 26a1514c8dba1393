"""TIMIT data preparation on the PyTorch port (the twin of
``recipes/TIMIT/timit_prepare.py``): index the LDC release (TRAIN/TEST
directories, .WAV and .PHN files) into JSON manifests of phone sequences,
folded from 61 to 39 phones; or write a synthetic phone-tone corpus for
``--debug`` runs. The same seed gives the same manifests and WAV files as
the JAX package's."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

PHONES = ["sil", "aa", "iy", "uw", "m", "s", "t", "k"]

# standard 61 -> 39 phone folding (Lee & Hon); identity entries omitted
FOLD = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n",
    "eng": "ng", "zh": "sh", "ux": "uw", "pcl": "sil", "tcl": "sil",
    "kcl": "sil", "bcl": "sil", "dcl": "sil", "gcl": "sil", "h#": "sil",
    "pau": "sil", "epi": "sil", "q": "sil",
}


def prepare_synthetic(data_folder, n_utt=10, sample_rate=16000, seed=0):
    """Write ``n_utt`` utterances of three phone tones (0.1 s each) and
    ``train.json``/``valid.json`` (the last two utterances) into
    ``data_folder``."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = {"train": {}, "valid": {}}
    for i in range(n_utt):
        phones = [(i + j) % (len(PHONES) - 1) + 1 for j in range(3)]
        sig = np.concatenate([
            np.sin(2 * np.pi * (200 + 120 * p)
                   * np.arange(1600) / sample_rate)
            for p in phones
        ]).astype(np.float32) * 0.5
        path = root / f"utt{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"utt{i}"] = {
            "wav": str(path),
            "phn": " ".join(PHONES[p] for p in phones),
            "length": len(sig),
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


def prepare_timit(data_folder, save_folder=None):
    """Index a real TIMIT release (TRAIN/ TEST/ with .wav + .phn)."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    for split_in, split_out in (("TRAIN", "train"), ("TEST", "valid")):
        base = root / split_in
        if not base.is_dir():
            base = root / split_in.lower()
        if not base.is_dir():
            continue
        items = {}
        for phn_file in sorted(base.rglob("*.[pP][hH][nN]")):
            phones = []
            for line in phn_file.read_text().splitlines():
                parts = line.split()
                if len(parts) == 3:
                    p = parts[2].lower()
                    phones.append(FOLD.get(p, p))
            # collapse repeated silences introduced by folding
            folded = [p for i, p in enumerate(phones)
                      if i == 0 or p != phones[i - 1] or p != "sil"]
            wav = phn_file.with_suffix(".WAV")
            if not wav.exists():
                wav = phn_file.with_suffix(".wav")
            utt = f"{phn_file.parent.name}_{phn_file.stem}"
            items[utt] = {
                "wav": str(wav), "phn": " ".join(folded), "length": 0,
            }
        with open(save / f"{split_out}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_timit(folder)
