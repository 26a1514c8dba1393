#!/usr/bin/env python
"""ZaionEmotionDataset speech emotion diarization on the PyTorch port, the
twin of ``recipes/ZaionEmotionDataset/emotion_diarization/train.py``:
Fbank -> CRDNN -> ``out_lin``, emotion logits a frame, NLL of their
log-softmax against frame labels taken from the emotion intervals (0,
neutral, outside every interval), Adam, a checkpoint kept by the lowest
valid loss. The LibriParty VAD twin's Brain, datasets, ``run`` and
``main``, with this objective and the manifests' ``emotion`` key.

With the run's YAML (``main``), the best checkpoint is exported to
``pretrained_folder`` for ``Speech_Emotion_Diarization.from_hparams``.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization.train \\
        speechbrain_tpu_torch/recipes/ZaionEmotionDataset/emotion_diarization/hparams/train.yaml \\
        --data_folder=results/zed_data --debug --device=cpu
"""

import functools
import sys

import torch

from speechbrain_tpu_torch.nnet.losses import nll_loss
from speechbrain_tpu_torch.recipes.LibriParty.VAD import train as vad
from speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization.prepare import (  # noqa: E501
    prepare_synthetic,
)


class EmoDiarBrain(vad.FrameBrain):
    """Emotion logits a frame, NLL of their log-softmax."""

    def compute_objectives(self, logits, batch, stage):
        wavs, _ = batch["sig"]
        intervals, _ = batch["emotion_intervals"]
        intervals = intervals.to(logits.device)
        inside = vad.frames_inside(logits.shape[1],
                                   wavs.shape[1] / self.hparams.sample_rate,
                                   intervals)
        emo_ids = intervals[..., 2].long()
        labels = torch.where(inside, emo_ids[:, None, :], 0).amax(dim=-1)
        return nll_loss(torch.log_softmax(logits, dim=-1), labels)


prepare_emotions = functools.partial(vad.dataio_prepare, key="emotion",
                                     provides="emotion_intervals", columns=3)


def run(hparams, run_opts, brain_cls=EmoDiarBrain, export_from=None):
    """The VAD twin's ``run`` with this Brain and the emotion intervals."""
    return vad.run(hparams, run_opts, brain_cls, export_from,
                   prepare=prepare_emotions)


def main(argv=None, run_fn=run, prepare_corpus=prepare_synthetic):
    return vad.main(argv, run_fn=run_fn, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
