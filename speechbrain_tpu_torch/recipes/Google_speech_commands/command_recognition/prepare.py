"""Google Speech Commands preparation on the PyTorch port (the twin of
``recipes/Google-speech-commands/command_recognition/prepare.py``): JSON
manifests from the dataset's folders, or a synthetic command set for
``--debug`` runs and tests (the same files and manifests as the JAX
package's)."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

COMMANDS = ["yes", "no", "up", "down", "left", "right"]


def prepare_synthetic(data_folder, n_per_class=4, sample_rate=16000):
    """``n_per_class`` one-second tones a command (300 + 120 i Hz over
    noise); the last of each command goes to ``valid.json``, the rest to
    ``train.json``. Returns the two manifests' paths."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = {"train": {}, "valid": {}}
    for ci, cmd in enumerate(COMMANDS):
        (root / cmd).mkdir(exist_ok=True)
        for i in range(n_per_class):
            freq = 300 + 120 * ci
            t = np.arange(sample_rate) / sample_rate
            sig = (np.sin(2 * np.pi * freq * t)
                   + 0.05 * rng.standard_normal(sample_rate)).astype(
                       np.float32)
            path = root / cmd / f"{cmd}_{i}.wav"
            write_audio(str(path), sig, sample_rate)
            split = "valid" if i == n_per_class - 1 else "train"
            entries[split][f"{cmd}_{i}"] = {
                "wav": str(path), "command": cmd, "length": sample_rate,
            }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


def prepare_gsc(data_folder):
    """Index the real dataset's ``<command>/<file>.wav`` folders; the
    files named in ``validation_list.txt`` go to ``valid.json``."""
    root = Path(data_folder)
    entries = {"train": {}, "valid": {}}
    val_file = root / "validation_list.txt"
    val_list = set(val_file.read_text().split()) if val_file.exists() \
        else set()
    for wav in sorted(root.glob("*/*.wav")):
        cmd = wav.parent.name
        if cmd.startswith("_"):
            continue
        rel = f"{cmd}/{wav.name}"
        split = "valid" if rel in val_list else "train"
        entries[split][rel.replace("/", "_")] = {
            "wav": str(wav), "command": cmd, "length": 16000,
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)
    return str(root / "train.json"), str(root / "valid.json")


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_gsc(folder)
