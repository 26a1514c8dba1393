"""Synthetic reverberant/clean pairs for ``--debug`` runs of the
dereverberation twin: the PyTorch port's copy of
``recipes/VoiceBank/dereverb/spectral_mask/prepare.py``, the same files
and manifests."""

import json
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic_reverb(data_folder, n_utts=8, sample_rate=16000,
                             seed=0):
    """``n_utts`` pairs of 1 s: a modulated tone, and the same convolved
    with one decaying random 400-tap room response (its first tap 1) and
    scaled to a peak of 0.5; the last two are the valid split."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "valid": {}}
    T = sample_rate
    t = np.arange(T) / sample_rate
    # a short exponentially-decaying random RIR
    rir = (rng.standard_normal(400)
           * np.exp(-np.arange(400) / 60.0)).astype(np.float32)
    rir[0] = 1.0
    for i in range(n_utts):
        am = 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
        clean = (0.5 * am * np.sin(2 * np.pi * (200 + 40 * i) * t)
                 ).astype(np.float32)
        rev = np.convolve(clean, rir)[:T].astype(np.float32)
        rev = rev / max(np.abs(rev).max(), 1e-6) * 0.5
        cp = root / f"clean_{i}.wav"
        rp = root / f"reverb_{i}.wav"
        write_audio(str(cp), clean, sample_rate)
        write_audio(str(rp), rev, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"u{i}"] = {
            "clean_wav": str(cp), "noisy_wav": str(rp),
            "length": T / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
