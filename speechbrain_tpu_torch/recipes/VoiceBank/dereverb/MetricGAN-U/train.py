#!/usr/bin/env python
"""VoiceBank MetricGAN-U dereverberation on the PyTorch port, the twin of
``recipes/VoiceBank/dereverb/MetricGAN-U/train.py``: the enhancement
MetricGAN-U twin (``enhance/MetricGAN-U/train.py``, SRMR as the target)
on reverberant speech; its ``--debug`` corpus is amplitude-modulated
tones through a comb of three decaying echoes.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.dereverb.MetricGAN-U.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/dereverb/MetricGAN-U/hparams/train_dereverb.yaml \\
        --data_folder=results/metricgan_u_dereverb_data --debug --device=cpu
"""

import importlib
import sys

from speechbrain_tpu_torch.recipes.VoiceBank.enhance import prepare

# the enhancement twin; its folder's name is no Python identifier
metricgan_u = importlib.import_module(
    "speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN-U.train")
MetricGanUBrain = metricgan_u.MetricGanUBrain
run = metricgan_u.run


def prepare_corpus(hparams):
    """The ``--debug`` corpus: modulated tones and their echoes."""
    prepare.prepare_synthetic(hparams["data_folder"], reverb=True)


def main(argv=None):
    return metricgan_u.main(argv, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
