#!/usr/bin/env python
"""WHAM! and WHAMR! separation on the PyTorch port, the twin of
``recipes/WHAMandWHAMR/separation/train.py``: the LibriMix twin's
``Separation`` (negated PIT SI-SNR over whole signals, Adam, the best
checkpoint by ``si-snr``) on mixtures with noise (and reverberation for
WHAMR!), trained against the clean sources.

Run from the repository's root (a synthetic noisy, reverberant corpus is
made under ``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.WHAMandWHAMR.separation.train \\
        speechbrain_tpu_torch/recipes/WHAMandWHAMR/separation/hparams/sepformer-wham.yaml \\
        --data_folder=results/wham_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    train as librimix,
)
from speechbrain_tpu_torch.recipes.WHAMandWHAMR.separation.prepare import (
    prepare_synthetic,
)

Separation = librimix.Separation
dataio_prepare = librimix.dataio_prepare
run = librimix.run


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``."""
    prepare_synthetic(hparams["data_folder"])


def main(argv=None):
    return librimix.main(argv, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
