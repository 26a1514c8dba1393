#!/usr/bin/env python
"""GigaSpeech Conformer transducer (RNN-T) ASR on the PyTorch port, the twin
of ``recipes/GigaSpeech/ASR/transducer/train.py``: the LibriSpeech
transducer twin's Brain, tokenizer and ``run`` over GigaSpeech's
manifests (``../CTC/prepare.py``), with the targets padded to a
multiple of 16 as the JAX recipe pads them.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.GigaSpeech.ASR.transducer.train \\
        speechbrain_tpu_torch/recipes/GigaSpeech/ASR/transducer/hparams/conformer_transducer.yaml \\
        --data_folder=results/gigaspeech_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.GigaSpeech.ASR.CTC.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train import (
    main,
)

# the targets' padded length (the JAX recipe's loader)
TOKENS_PAD_MULTIPLE = 16


def prepare(hparams):
    prepare_synthetic(hparams["data_folder"])


if __name__ == "__main__":
    main(sys.argv[1:], prepare=prepare,
         pad_to_multiple={"tokens": TOKENS_PAD_MULTIPLE})
