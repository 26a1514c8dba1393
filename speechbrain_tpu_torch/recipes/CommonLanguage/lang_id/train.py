#!/usr/bin/env python
"""CommonLanguage spoken language identification on the PyTorch port, the
twin of ``recipes/CommonLanguage/lang_id/train.py``: Fbank -> ECAPA-TDNN
(given the relative lengths) -> the cosine ``Classifier`` ->
``log_softmax(10 cos)`` -> NLL over the languages, Adam, a checkpoint kept
by the lowest valid loss; the VoxLingua107 and IEMOCAP twins run the same
Brain over their own label key.

With the run's YAML (``main``), the best checkpoint is exported to
``pretrained_folder`` for ``EncoderClassifier.from_hparams``
(``utils/pretrained.export_classifier``).

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.CommonLanguage.lang_id.train \\
        speechbrain_tpu_torch/recipes/CommonLanguage/lang_id/hparams/train_ecapa.yaml \\
        --data_folder=results/cl_data --debug --device=cpu
"""

import functools
import sys

import torch

from speechbrain_tpu_torch.nnet.losses import classification_error, nll_loss
from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.ESC50.classification import train as esc50

# the cosine classifier's scale before the log-softmax (train.py:34)
COSINE_SCALE = 10.0


class LangIdBrain(esc50.SoundBrain):
    """Fbank -> embedding model (with lengths) -> cosine classifier ->
    ``log_softmax(10 cos)`` -> NLL."""

    def compute_forward(self, batch, stage):
        wavs, lens = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        emb = self.modules.embedding_model(feats, lengths=lens)
        cos = self.modules.classifier(emb)
        return torch.log_softmax(cos.float() * COSINE_SCALE, dim=-1)

    def compute_objectives(self, logp, batch, stage):
        label = batch["class_encoded"].data.reshape(-1)
        return nll_loss(logp, label), {
            "error": classification_error(logp, label)}


def run(hparams, run_opts, brain_cls=LangIdBrain, export_from=None,
        label_key="language"):
    """The ESC50 twin's ``run`` with this Brain and ``label_key``."""
    return esc50.run(hparams, run_opts, brain_cls, export_from,
                     prepare=functools.partial(esc50.dataio_prepare,
                                               label_key=label_key))


def main(argv=None, run_fn=run, prepare_corpus=prepare_synthetic):
    return esc50.main(argv, run_fn=run_fn, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
