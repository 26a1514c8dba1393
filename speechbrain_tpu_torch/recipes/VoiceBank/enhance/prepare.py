"""The synthetic noisy/clean corpora of the VoiceBank enhancement twins'
``--debug`` runs: the PyTorch port's copy of ``prepare_synthetic`` of
``recipes/VoiceBank/enhance/MetricGAN-U/train.py`` (and, by its options,
of the SEGAN, ``enhancement`` and ``dereverb/MetricGAN-U`` scripts), the
same files and manifests, kept here where every VoiceBank enhancement
twin can import it."""

import json
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio


def prepare_synthetic(data_folder, n_utts=8, sample_rate=16000, seed=0,
                      modulated=True, reverb=False):
    """``n_utts`` pairs of 1 s: a tone at ``200 + 50 i`` Hz under a 4 Hz
    amplitude modulation, and the same plus white noise at 0.2; the last
    two are the valid split. Manifests ``{utt: {clean_wav, noisy_wav,
    length}}`` (length in seconds).

    ``modulated=False`` leaves the tone unmodulated (the corpus of the
    JAX package's SEGAN and ``VoiceBank/enhancement`` scripts);
    ``reverb=True`` makes the noisy signal the tone through a comb of
    three decaying echoes at 25, 50 and 75 ms instead of the noise (that
    of ``dereverb/MetricGAN-U/train.py``)."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "valid": {}}
    T = sample_rate
    t = np.arange(T) / sample_rate
    for i in range(n_utts):
        am = 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) if modulated else 1.0
        clean = (0.5 * am * np.sin(2 * np.pi * (200 + 50 * i) * t)
                 ).astype(np.float32)
        if reverb:
            ir = np.zeros(1600, np.float32)
            ir[0] = 1.0
            for d in (400, 800, 1200):
                ir[d] = 0.5 * np.exp(-d / 800)
            noisy = np.convolve(clean, ir)[:T].astype(np.float32)
        else:
            noisy = clean + 0.2 * rng.standard_normal(T).astype(np.float32)
        cp = root / f"clean_{i}.wav"
        np_ = root / f"noisy_{i}.wav"
        write_audio(str(cp), clean, sample_rate)
        write_audio(str(np_), noisy, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"u{i}"] = {
            "clean_wav": str(cp), "noisy_wav": str(np_),
            "length": T / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
