#!/usr/bin/env python
"""Aishell1Mix Mandarin separation on the PyTorch port, the twin of
``recipes/Aishell1Mix/separation/train.py``: the LibriMix twin's
``Separation`` (negated PIT SI-SNR over the YAML's ``num_spks`` sources,
whole signals, Adam, the best checkpoint by ``si-snr``), with WHAM! noise
in the mixtures where the YAML says ``wham_noise``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.Aishell1Mix.separation.train \\
        speechbrain_tpu_torch/recipes/Aishell1Mix/separation/hparams/sepformer-aishell1mix2.yaml \\
        --data_folder=results/aishell1mix_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.Aishell1Mix.separation.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    train as librimix,
)

Separation = librimix.Separation
dataio_prepare = librimix.dataio_prepare
run = librimix.run


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``: the YAML's number of
    speakers, with noise where it says ``wham_noise``."""
    prepare_synthetic(hparams["data_folder"],
                      num_spks=hparams.get("num_spks", 2),
                      wham_noise=hparams.get("wham_noise", False))


def main(argv=None):
    return librimix.main(argv, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
