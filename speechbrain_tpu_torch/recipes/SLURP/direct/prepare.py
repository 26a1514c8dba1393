"""SLURP preparation (reference recipes/SLURP/prepare.py): parse the
jsonl annotation files of the SLURP release into JSON manifests mapping
utterance -> {wav, semantics, transcript}; or emit a synthetic
tone-command dataset for --debug runs / recipe tests.

The PyTorch port's twin of
``recipes/SLURP/direct/prepare.py``: the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

SCENARIOS = ["calendar", "email", "alarm", "play"]
ACTIONS = ["create", "remove", "query"]


def prepare_synthetic(data_folder, n_utts=12, sample_rate=16000, seed=0):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "devel": {}, "test": {}}
    for i in range(n_utts):
        s = int(rng.integers(0, len(SCENARIOS)))
        a = int(rng.integers(0, len(ACTIONS)))
        t = np.arange(int(0.3 * sample_rate)) / sample_rate
        sig = 0.5 * np.sin(2 * np.pi * (250 + 100 * s) * t)
        sig += 0.5 * np.sin(2 * np.pi * (900 + 150 * a) * t)
        sig = sig.astype(np.float32)
        sig += 0.01 * rng.standard_normal(len(sig)).astype(np.float32)
        path = root / f"slurp_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        semantics = (
            f"{{'scenario': '{SCENARIOS[s]}', 'action': '{ACTIONS[a]}'}}"
        )
        split = ("devel" if i % 6 == 4 else "test" if i % 6 == 5
                 else "train")
        manifests[split][f"slurp_{i}"] = {
            "wav": str(path),
            "semantics": semantics,
            "transcript": f"{SCENARIOS[s]} {ACTIONS[a]}",
            "length": len(sig) / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def prepare_slurp(data_folder, save_folder=None):
    """Index a real SLURP release: slurp_real/ audio + dataset/slurp/
    {train,devel,test}.jsonl annotations."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    for split in ("train", "devel", "test"):
        jsonl = root / "dataset" / "slurp" / f"{split}.jsonl"
        manifest = {}
        with open(jsonl, encoding="utf-8") as f:
            for line in f:
                e = json.loads(line)
                semantics = str(
                    {
                        "scenario": e["scenario"],
                        "action": e["action"],
                        "entities": [
                            {"type": ent["type"], "filler": ent["filler"]}
                            for ent in e.get("entities", [])
                        ],
                    }
                )
                for rec in e.get("recordings", []):
                    wav = root / "slurp_real" / rec["file"]
                    manifest[rec["file"]] = {
                        "wav": str(wav),
                        "semantics": semantics,
                        "transcript": e.get("sentence", ""),
                        "length": 0.0,
                    }
        with open(save / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_slurp(folder)
