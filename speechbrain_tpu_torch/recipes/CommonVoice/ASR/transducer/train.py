#!/usr/bin/env python
"""CommonVoice Conformer transducer (RNN-T) ASR on the PyTorch port, the
twin of ``recipes/CommonVoice/ASR/transducer/train.py``: the LibriSpeech
transducer twin's Brain, tokenizer and ``run`` over CommonVoice's
manifests.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.CommonVoice.ASR.transducer.train \\
        speechbrain_tpu_torch/recipes/CommonVoice/ASR/transducer/hparams/conformer_transducer.yaml \\
        --data_folder=results/cv_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.CommonVoice.commonvoice_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train import (
    main,
)


def prepare(hparams):
    prepare_synthetic(hparams["data_folder"])


if __name__ == "__main__":
    main(sys.argv[1:], prepare=prepare)
