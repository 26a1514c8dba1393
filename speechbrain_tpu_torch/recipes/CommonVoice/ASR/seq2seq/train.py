#!/usr/bin/env python
"""CommonVoice CRDNN attention seq2seq ASR on the PyTorch port, the twin of
``recipes/CommonVoice/ASR/seq2seq/train.py``.

The JAX script is the LibriSpeech seq2seq script with CommonVoice's data
preparation (``commonvoice_prepare.py``), so the twin runs the LibriSpeech
twin's ``ASR`` and ``run`` over this corpus's synthetic utterances:
Fbank -> sentence normalisation -> CRDNN -> GRU decoder with location
attention, CTC (0.5) + label-smoothed NLL over BPE targets, Adadelta
annealed by NewBob. ``train.yaml`` and the six ``train_<lang>.yaml`` hold
the same values but the output folder and the language.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.CommonVoice.ASR.seq2seq.train \\
        speechbrain_tpu_torch/recipes/CommonVoice/ASR/seq2seq/hparams/train.yaml \\
        --data_folder=results/cv_data --debug --device=cpu
"""

import functools
import sys

from speechbrain_tpu_torch.recipes.CommonVoice.commonvoice_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import (
    train as librispeech,
)

ASR = librispeech.ASR
run = functools.partial(librispeech.run, prepare=prepare_synthetic)


def main(argv=None):
    return librispeech.main(argv, run_fn=run)


if __name__ == "__main__":
    main(sys.argv[1:])
