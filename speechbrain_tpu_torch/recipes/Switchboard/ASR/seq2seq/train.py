#!/usr/bin/env python
"""Switchboard CRDNN attention seq2seq ASR on the PyTorch port, the twin
of ``recipes/Switchboard/ASR/seq2seq/train.py``.

The JAX script is the LibriSpeech seq2seq chain (BPE tokenizer over the
words, CTC + NLL, Adadelta and NewBob, batches padded to whole seconds)
with Switchboard's preparation, which it reads from the CTC recipe's
folder (``Switchboard/ASR/CTC/prepare.py``); so the twin runs the
LibriSpeech twin's ``ASR`` and ``run`` with that preparation's synthetic
conversations.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.Switchboard.ASR.seq2seq.train \\
        speechbrain_tpu_torch/recipes/Switchboard/ASR/seq2seq/hparams/train.yaml \\
        --data_folder=results/swbd_data --debug --device=cpu
"""

import functools
import sys

from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import (
    train as librispeech,
)
from speechbrain_tpu_torch.recipes.Switchboard.ASR.CTC.prepare import (
    prepare_synthetic as _prepare_synthetic,
)

ASR = librispeech.ASR


def prepare_synthetic(data_folder, save_folder=None):
    """The CTC folder's ``prepare_synthetic`` (its manifests go beside the
    audio, as the JAX script calls it)."""
    return _prepare_synthetic(data_folder)


run = functools.partial(librispeech.run, prepare=prepare_synthetic)


def main(argv=None):
    return librispeech.main(argv, run_fn=run)


if __name__ == "__main__":
    main(sys.argv[1:])
