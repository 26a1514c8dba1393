#!/usr/bin/env python
"""Binaural WSJ0-2mix separation on the PyTorch port, the twin of
``recipes/BinauralWSJ0Mix/separation/train.py``: stereo mixtures (B, T, 2)
-> estimates (B, T, 2, n_src), by a stereo model where the YAML says
``stereo_model`` (the binaural Conv-TasNet in its ``independent``,
``cross`` or ``parallel`` mode) or by a mono model run on each ear
(``sepformer-binaural.yaml``); the negated PIT SI-SNR with the two ears
folded into time, Adam, the best checkpoint by ``si-snr``.

Run from the repository's root (a synthetic binaural corpus, with noise
or reverberation where the YAML says so, is made under ``--debug`` where
the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.BinauralWSJ0Mix.separation.train \\
        speechbrain_tpu_torch/recipes/BinauralWSJ0Mix/separation/hparams/convtasnet-cross.yaml \\
        --data_folder=results/binaural_data --debug --device=cpu
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.dataio.dataio import (
    read_audio_multichannel,
    write_audio,
)
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import get_si_snr_with_pitwrapper
from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    train as librimix,
)


class BinauralSeparation(librimix.Separation):
    """Stereo mixture -> (B, T, 2, n_src) estimates; the PIT objective
    over the sources with each utterance's two ears folded into time."""

    def compute_forward(self, batch, stage):
        mix, _ = batch["mix_sig"]
        if getattr(self.hparams, "stereo_model", False):
            return self.modules.model(mix)
        return torch.stack([self.modules.model(mix[..., ch])
                            for ch in range(2)], dim=2)

    def compute_objectives(self, est, batch, stage):
        s1, s2 = batch["s1_sig"].data, batch["s2_sig"].data
        B, T = s1.shape[:2]
        sources = torch.stack([s1, s2], dim=-1).reshape(B, T * 2, 2)
        est = est.float().reshape(B, T * 2, 2)
        return get_si_snr_with_pitwrapper(sources, est).mean()


def prepare_synthetic(data_folder, n_utt=8, sample_rate=8000,
                      seconds=1.0, seed=0, noise=False, reverb=False):
    """Binaural mixtures: a sine louder in the left ear and a square wave
    louder in the right (half the amplitude in the other ear), with an
    8 ms echo at 0.3 in each ear (``reverb``) and white noise at 0.1
    (``noise``); the last two the valid split."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    T = int(sample_rate * seconds)
    t = np.arange(T) / sample_rate
    entries = {"train": {}, "valid": {}}
    for i in range(n_utt):
        f1, f2 = rng.uniform(200, 400), rng.uniform(500, 900)
        s1 = np.sin(2 * np.pi * f1 * t).astype(np.float32)
        s2 = (0.6 * np.sign(np.sin(2 * np.pi * f2 * t))).astype(np.float32)
        # interaural level difference: s1 left-dominant, s2 right
        s1st = np.stack([s1, 0.5 * s1], -1)
        s2st = np.stack([0.5 * s2, s2], -1)
        if reverb:
            # cheap binaural "room": attenuated 8 ms echo per ear
            d = int(0.008 * sample_rate)
            for st in (s1st, s2st):
                st[d:] += 0.3 * st[:-d]
        mix = (s1st + s2st).astype(np.float32)
        if noise:
            mix = mix + 0.1 * rng.standard_normal(mix.shape).astype(
                np.float32)
        paths = {}
        for name, sig in (("mix", mix), ("s1", s1st), ("s2", s2st)):
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


def dataio_prepare(hparams):
    """Train and valid datasets of the stereo signals (``mix_sig``,
    ``s1_sig``, ``s2_sig``, each (T, 2))."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        for k in ("mix", "s1", "s2"):
            # stereo (T, 2): read_audio would average to mono
            ds.add_dynamic_item(read_audio_multichannel, takes=f"{k}_wav",
                                provides=f"{k}_sig")
        ds.set_output_keys(["id", "mix_sig", "s1_sig", "s2_sig"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=BinauralSeparation,
        prepare=dataio_prepare, export_from=None):
    """The LibriMix twin's ``run`` with this recipe's Brain and stereo
    datasets."""
    return librimix.run(hparams, run_opts, brain_cls=brain_cls,
                        prepare=prepare, export_from=export_from)


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``, with the YAML's noise
    and reverberation."""
    prepare_synthetic(hparams["data_folder"],
                      sample_rate=hparams["sample_rate"],
                      noise=hparams.get("with_noise", False),
                      reverb=hparams.get("with_reverb", False))


def main(argv=None):
    return librimix.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
