#!/usr/bin/env python
"""UrbanSound8k sound classification on the PyTorch port, the twin of
``recipes/UrbanSound8k/SoundClassification/train.py``: Fbank -> Cnn14 or
ECAPA-TDNN -> the mean over time -> a linear or cosine classifier, NLL
over the urban sound classes, Adam.

The JAX script is the ESC50 script with the mean over time only (its
encoders give no 4-D map) and the classifier's output taken at ``[:, 0]``
only where it is 3-D (the ECAPA ``Classifier`` gives (batch, classes));
so the twin runs the ESC50 twin's ``SoundBrain`` and ``PooledEncoder``
(an ECAPA embedding is (B, 1, D): its mean over time is itself), with its
own synthetic corpus.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.UrbanSound8k.SoundClassification.train \\
        speechbrain_tpu_torch/recipes/UrbanSound8k/SoundClassification/hparams/cnn14.yaml \\
        --data_folder=results/us8k_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.ESC50.classification.train import (  # noqa: F401,E501
    PooledEncoder,
    SoundBrain,
    dataio_prepare,
    main as _main,
    run,
)
from speechbrain_tpu_torch.recipes.UrbanSound8k.SoundClassification.prepare import (  # noqa: E501
    prepare_synthetic,
)


def main(argv=None):
    return _main(argv, prepare_corpus=prepare_synthetic)


if __name__ == "__main__":
    main(sys.argv[1:])
