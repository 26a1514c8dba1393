"""VoxCeleb preparation on the PyTorch port (the twin of
``recipes/VoxCeleb/SpeakerRec/prepare.py``): index ``wav/{spk}/{session}/
*.wav`` into JSON manifests with speaker labels, or write a synthetic
speaker-tone corpus for ``--debug`` runs and tests (the same seed gives
the same manifests and WAV files as the JAX package's). Beyond the JAX
script, :func:`write_trials` writes a verification trials file for the
verification script."""

import itertools
import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

TRIALS_FILE = "veri_pairs.txt"


def prepare_synthetic(data_folder, n_spk=4, n_per_spk=3,
                      sample_rate=16000, seed=0, save_folder=None):
    """``n_spk`` speakers (a tone and its octave at 120 + 60 s Hz over
    noise), ``n_per_spk`` utterances of 1.2 s each; the last of each
    speaker goes to ``dev.json``, the rest to ``train.json``, in
    ``save_folder`` (``data_folder`` by default)."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    save = Path(save_folder) if save_folder else root
    save.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = {"train": {}, "valid": {}}
    t = np.arange(int(1.2 * sample_rate)) / sample_rate
    for s in range(n_spk):
        f0 = 120 + 60 * s
        for i in range(n_per_spk):
            sig = 0.5 * (np.sin(2 * np.pi * f0 * t)
                         + 0.3 * np.sin(2 * np.pi * 2 * f0 * t))
            sig = sig.astype(np.float32)
            sig += 0.02 * rng.standard_normal(len(sig)).astype(np.float32)
            path = root / f"spk{s}_{i}.wav"
            write_audio(str(path), sig, sample_rate)
            split = "valid" if i == n_per_spk - 1 else "train"
            entries[split][f"spk{s}_{i}"] = {
                "wav": str(path), "spk_id": f"spk{s}",
                "length": len(sig) / sample_rate,
            }
    # the VoxCeleb YAMLs name the validation manifest dev.json
    entries["dev"] = entries.pop("valid")
    for split, items in entries.items():
        with open(save / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


def write_trials(data_folder, manifests, path=None):
    """A trials file (``label enrol test`` a line, label 1 for one
    speaker, paths relative to ``data_folder``) over every pair of the
    utterances in ``manifests``; returns its path (``data_folder/
    veri_pairs.txt`` by default)."""
    root = Path(data_folder)
    utts = []
    for manifest in manifests:
        with open(manifest, encoding="utf-8") as f:
            for entry in json.load(f).values():
                rel = Path(entry["wav"]).resolve().relative_to(
                    root.resolve())
                utts.append((entry["spk_id"], rel.as_posix()))
    path = Path(path or root / TRIALS_FILE)
    with open(path, "w", encoding="utf-8") as f:
        for (s1, w1), (s2, w2) in itertools.combinations(sorted(utts), 2):
            f.write(f"{int(s1 == s2)} {w1} {w2}\n")
    return path


def prepare_voxceleb(data_folder, save_folder=None):
    """Index a real VoxCeleb release (``wav/{spk}/{session}/*.wav``):
    every 20th file goes to ``valid.json``."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    entries = {"train": {}, "valid": {}}
    wavs = sorted((root / "wav").rglob("*.wav"))
    for i, wav in enumerate(wavs):
        spk = wav.parts[-3]
        split = "valid" if i % 20 == 19 else "train"
        entries[split][f"{spk}_{wav.parent.name}_{wav.stem}"] = {
            "wav": str(wav), "spk_id": spk, "length": 0,
        }
    for split, items in entries.items():
        with open(save / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_voxceleb(folder)
