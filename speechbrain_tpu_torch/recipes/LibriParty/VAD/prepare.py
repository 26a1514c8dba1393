"""LibriParty preparation (reference
recipes/LibriParty/VAD/libriparty_prepare.py): the release ships JSON
session metadata with per-utterance speech intervals; this indexer
emits {wav, speech: [[start, end], ...]} manifests. The synthetic mode
builds tone-burst "parties" with known speech intervals for --debug
runs / recipe tests.

The PyTorch port's twin of ``recipes/LibriParty/VAD/prepare.py``: the
same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic(data_folder, n_utts=8, sample_rate=16000,
                      seconds=2.0, seed=0):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    T = int(sample_rate * seconds)
    t = np.arange(T) / sample_rate
    manifests = {"train": {}, "valid": {}}
    for i in range(n_utts):
        sig = rng.normal(0, 0.01, T).astype(np.float32)
        start = float(rng.uniform(0.2, 0.8))
        end = float(start + rng.uniform(0.4, 0.8))
        burst = (t >= start) & (t < end)
        sig[burst] += 0.5 * np.sin(
            2 * np.pi * (200 + 40 * i) * t[burst]
        ).astype(np.float32)
        path = root / f"party_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"party_{i}"] = {
            "wav": str(path),
            "speech": [[start, min(end, seconds)]],
            "duration": seconds,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def prepare_libriparty(data_folder, save_folder=None):
    """Index a real LibriParty release from its metadata JSONs."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    for split_in, split_out in (("train", "train"), ("dev", "valid"),
                                ("eval", "test")):
        meta = root / "metadata" / f"{split_in}.json"
        if not meta.exists():
            continue
        with open(meta, encoding="utf-8") as f:
            sessions = json.load(f)
        manifest = {}
        for sess, info in sessions.items():
            intervals = []
            for spk_utts in info.values():
                if not isinstance(spk_utts, list):
                    continue
                for utt in spk_utts:
                    if isinstance(utt, dict) and "start" in utt:
                        intervals.append(
                            [float(utt["start"]), float(utt["stop"])]
                        )
            wav = root / f"{split_in}" / f"{sess}.wav"
            manifest[sess] = {
                "wav": str(wav),
                "speech": sorted(intervals),
                "duration": 0.0,
            }
        with open(save / f"{split_out}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_libriparty(folder)
