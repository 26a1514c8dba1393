"""ZaionEmotionDataset preparation (reference
recipes/ZaionEmotionDataset/zed_prepare.py): the release JSON marks
per-utterance emotion intervals; this indexer emits
{wav, emotion: [[start, end, emo_id], ...]} manifests. Synthetic mode
builds tone utterances with one emotional (modulated) interval.

The PyTorch port's twin of
``recipes/ZaionEmotionDataset/emotion_diarization/prepare.py``: the same
files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

EMOTIONS = {"neutral": 0, "happy": 1, "sad": 2, "angry": 3}


def prepare_synthetic(data_folder, n_utts=8, sample_rate=16000,
                      seconds=2.0, seed=0):
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    T = int(sample_rate * seconds)
    t = np.arange(T) / sample_rate
    manifests = {"train": {}, "valid": {}}
    for i in range(n_utts):
        emo = 1 + i % 3
        sig = 0.4 * np.sin(2 * np.pi * 220 * t).astype(np.float32)
        start = float(rng.uniform(0.3, 0.9))
        end = float(start + rng.uniform(0.4, 0.8))
        seg = (t >= start) & (t < end)
        # emotion -> distinct modulation rate
        sig[seg] *= (1 + 0.9 * np.sin(2 * np.pi * (2 + 3 * emo) * t[seg])
                     ).astype(np.float32)
        path = root / f"zed_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"zed_{i}"] = {
            "wav": str(path),
            "emotion": [[start, min(end, seconds), emo]],
            "duration": seconds,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def prepare_zed(data_folder, save_folder=None):
    """Index a real ZED release from its ZED.json metadata."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    with open(root / "ZED.json", encoding="utf-8") as f:
        meta = json.load(f)
    manifests = {"train": {}, "valid": {}}
    for i, (utt, info) in enumerate(sorted(meta.items())):
        intervals = [
            [float(iv["start"]), float(iv["end"]),
             EMOTIONS.get(iv.get("emotion", "neutral"), 0)]
            for iv in info.get("intervals", [])
        ]
        split = "valid" if i % 10 == 9 else "train"
        manifests[split][utt] = {
            "wav": str(root / info["wav"]),
            "emotion": intervals,
            "duration": float(info.get("duration", 0.0)),
        }
    for split, manifest in manifests.items():
        with open(save / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_zed(folder)
