#!/usr/bin/env python
"""Libri-Light wav2vec 2.0 pretraining on the PyTorch port, the twin of
``recipes/Libri-Light/self-supervised-learning/wav2vec2/train.py``: the
LibriSpeech twin's chain (``train_sb_wav2vec2.run``) with InfoNCE alone (no
diversity term) over its own untranscribed tone corpus
(:func:`prepare_synthetic`, the JAX script's byte for byte).

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.Libri-Light.self-supervised-learning.wav2vec2.train \\
        speechbrain_tpu_torch/recipes/Libri-Light/self-supervised-learning/wav2vec2/hparams/wav2vec2.yaml \\
        --data_folder=results/ll_data --debug --device=cpu
"""

import json
import sys
from importlib import import_module
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.lobes.models.wav2vec import w2v_contrastive_loss
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)

ls_w2v = import_module("speechbrain_tpu_torch.recipes.LibriSpeech."
                       "self-supervised-learning.wav2vec2.train_sb_wav2vec2")


class W2V2Pretrain(ls_w2v.SBW2V2Pretrain):
    """The LibriSpeech twin's forward; the loss is InfoNCE alone."""

    def compute_objectives(self, predictions, batch, stage):
        preds, targets, negs, mask, _ = predictions
        return w2v_contrastive_loss(
            preds, targets.detach(), negs.detach(), mask,
            temperature=self.hparams.temperature)


def prepare_synthetic(data_folder, n_utts=10, sample_rate=16000, seed=0):
    """Unlabeled tone utterances (Libri-Light is untranscribed)."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "valid": {}}
    for i in range(n_utts):
        t = np.arange(int(0.5 * sample_rate)) / sample_rate
        sig = 0.5 * np.sin(2 * np.pi * (200 + 60 * (i % 5)) * t)
        sig = sig.astype(np.float32)
        sig += 0.01 * rng.standard_normal(len(sig)).astype(np.float32)
        path = root / f"ll_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"ll_{i}"] = {
            "wav": str(path), "length": len(sig) / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def run(hparams, run_opts, brain_cls=W2V2Pretrain):
    """``train_sb_wav2vec2.run`` over this corpus."""
    return ls_w2v.run(hparams, run_opts, brain_cls=brain_cls,
                      prepare=prepare_synthetic)


def main(argv=None):
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
