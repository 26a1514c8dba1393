#!/usr/bin/env python
"""VoiceBank spectral-mask dereverberation on the PyTorch port, the twin
of ``recipes/VoiceBank/dereverb/spectral_mask/train.py``: the enhancement
twin's masking model and objective (``EnhanceBrain``, ``run``) on
reverberant inputs, a BLSTM masker by default.

Run from the repository's root (a synthetic reverberant corpus is made
under ``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.dereverb.spectral_mask.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/dereverb/spectral_mask/hparams/train.yaml \\
        --data_folder=results/dereverb_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.VoiceBank.dereverb.spectral_mask.prepare import (  # noqa: E501
    prepare_synthetic_reverb,
)
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)

EnhanceBrain = spectral_mask.EnhanceBrain
run = spectral_mask.run


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``."""
    prepare_synthetic_reverb(hparams["data_folder"])


def main(argv=None):
    return spectral_mask.main(argv, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
