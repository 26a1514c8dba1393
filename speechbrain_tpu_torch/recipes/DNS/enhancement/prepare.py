"""DNS (Deep Noise Suppression) preparation: the PyTorch port's twin of
``recipes/DNS/enhancement/prepare.py``, the same files and manifests.
``prepare_synthetic`` writes noisy-tone pairs for ``--debug`` runs;
``prepare_dns`` indexes the challenge's layout."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic(data_folder, n_utt=8, sample_rate=8000, seconds=1.0):
    """``n_utt`` pairs: a tone between 200 and 500 Hz, and the same plus
    white noise at 0.5; the last two are the valid split. Returns the
    manifests' paths."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    T = int(sample_rate * seconds)
    t = np.arange(T) / sample_rate
    entries = {"train": {}, "valid": {}}
    for i in range(n_utt):
        clean = np.sin(2 * np.pi * rng.uniform(200, 500) * t).astype(
            np.float32
        )
        noise = 0.5 * rng.standard_normal(T).astype(np.float32)
        noisy = clean + noise
        paths = {}
        for name, sig in (("noisy", noisy), ("clean", clean)):
            p = root / f"u{i}_{name}.wav"
            write_audio(str(p), sig, sample_rate)
            paths[name] = str(p)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"u{i}"] = {
            "noisy_wav": paths["noisy"], "clean_wav": paths["clean"],
            "length": T,
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_dns(data_folder):
    """Index the DNS challenge layout (``noisy/`` and ``clean/`` with
    fileid-matched names) into ``train.json``."""
    root = Path(data_folder)
    items = {}
    for noisy in sorted((root / "noisy").glob("*.wav")):
        fileid = noisy.stem.split("_fileid_")[-1]
        clean = root / "clean" / f"clean_fileid_{fileid}.wav"
        if clean.exists():
            items[noisy.stem] = {
                "noisy_wav": str(noisy), "clean_wav": str(clean),
                "length": 0,
            }
    with open(root / "train.json", "w") as f:
        json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_dns(folder)
