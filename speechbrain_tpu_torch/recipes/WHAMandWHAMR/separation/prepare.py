"""WHAM!/WHAMR! preparation (reference
recipes/WHAMandWHAMR/prepare_data.py): index wav8k/min mixture/source
dirs into JSON manifests, or synthesize tiny noisy (reverberant)
2-speaker mixtures for --debug runs / recipe tests.

The PyTorch port's twin of ``recipes/WHAMandWHAMR/separation/prepare.py``:
the same files and manifests."""

import json
import sys
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic(data_folder, n_utt=8, sample_rate=8000, seconds=1.0,
                      reverb=True):
    """``n_utt`` mixtures of a sine and a square wave, each with an echo
    12 ms later at 0.3 (``reverb``), plus white noise at 0.1; the sources
    are the dry signals. The last two are the valid split."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    T = int(sample_rate * seconds)
    entries = {"train": {}, "valid": {}}
    t = np.arange(T) / sample_rate
    for i in range(n_utt):
        f1, f2 = rng.uniform(200, 400), rng.uniform(500, 900)
        s1 = np.sin(2 * np.pi * f1 * t).astype(np.float32)
        s2 = (0.6 * np.sign(np.sin(2 * np.pi * f2 * t))).astype(np.float32)
        if reverb:
            # cheap 2-tap "room": direct + attenuated 12ms echo
            d = int(0.012 * sample_rate)
            s1r = s1 + 0.3 * np.pad(s1, (d, 0))[:-d or None][:T]
            s2r = s2 + 0.3 * np.pad(s2, (d, 0))[:-d or None][:T]
        else:
            s1r, s2r = s1, s2
        noise = 0.1 * rng.standard_normal(T).astype(np.float32)
        mix = (s1r + s2r + noise).astype(np.float32)
        paths = {}
        for name, sig in (("mix", mix), ("s1", s1), ("s2", s2)):
            p = root / f"u{i}_{name}.wav"
            write_audio(str(p), sig, sample_rate)
            paths[name] = str(p)
        split = "valid" if i >= n_utt - 2 else "train"
        entries[split][f"u{i}"] = {
            "mix_wav": paths["mix"], "s1_wav": paths["s1"],
            "s2_wav": paths["s2"], "length": T,
        }
    for split, items in entries.items():
        with open(root / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


def prepare_wham(data_folder, save_folder=None, variant="whamr"):
    """Index a real WHAM/WHAMR release (wav8k/min layout)."""
    root = Path(data_folder)
    save = Path(save_folder or data_folder)
    save.mkdir(parents=True, exist_ok=True)
    split_map = {"train": "tr", "valid": "cv", "test": "tt"}
    for split, name in split_map.items():
        base = root / "wav8k" / "min" / name
        mix_dir = (
            base / ("mix_both_reverb" if variant == "whamr" else "mix_both")
        )
        if not mix_dir.exists():
            continue
        items = {}
        for mix in sorted(mix_dir.glob("*.wav")):
            items[mix.stem] = {
                "mix_wav": str(mix),
                "s1_wav": str(base / "s1" / mix.name),
                "s2_wav": str(base / "s2" / mix.name),
                "length": 0,
            }
        with open(save / f"{split}.json", "w") as f:
            json.dump(items, f, indent=2)


if __name__ == "__main__":
    folder = sys.argv[1]
    if len(sys.argv) > 2 and sys.argv[2] == "--synthetic":
        prepare_synthetic(folder)
    else:
        prepare_wham(folder)
