#!/usr/bin/env python
"""Libri-Light BEST-RQ pretraining on the PyTorch port, the twin of
``recipes/Libri-Light/self-supervised-learning/BEST-RQ/train.py``: the
LibriSpeech BEST-RQ twin's chain (kernel B3 on every batch, the encoder
exported for CTC fine-tuning) over the Libri-Light wav2vec 2.0 twin's
corpus.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.Libri-Light.self-supervised-learning.BEST-RQ.train \\
        speechbrain_tpu_torch/recipes/Libri-Light/self-supervised-learning/BEST-RQ/hparams/bestrq.yaml \\
        --data_folder=results/ll_data --debug --device=cpu
"""

import sys
from importlib import import_module

from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)

ls_brq = import_module("speechbrain_tpu_torch.recipes.LibriSpeech."
                       "self-supervised-learning.BEST-RQ.train")
ll_w2v = import_module("speechbrain_tpu_torch.recipes.Libri-Light."
                       "self-supervised-learning.wav2vec2.train")


def run(hparams, run_opts, brain_cls=ls_brq.BestRQ):
    """The LibriSpeech BEST-RQ twin's ``run`` over the Libri-Light
    corpus."""
    return ls_brq.run(hparams, run_opts, brain_cls=brain_cls,
                      prepare=ll_w2v.prepare_synthetic)


def main(argv=None):
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
