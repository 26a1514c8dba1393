#!/usr/bin/env python
"""CommonVoice wav2vec 2.0 continued pretraining on the PyTorch port, the
twin of ``recipes/CommonVoice/self-supervised-learning/wav2vec2/train_hf_wav2vec2.py``:
the LibriSpeech twin's objective (InfoNCE plus the diversity term) and
chain over the CommonVoice synthetic corpus. Despite its name, the YAML
builds the port's native modules.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.CommonVoice.self-supervised-learning.wav2vec2.train_hf_wav2vec2 \\
        speechbrain_tpu_torch/recipes/CommonVoice/self-supervised-learning/wav2vec2/hparams/train_hf_wav2vec2.yaml \\
        --data_folder=results/cv_data --debug --device=cpu
"""

import sys
from importlib import import_module

from speechbrain_tpu_torch.recipes.CommonVoice.commonvoice_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)

ls_w2v = import_module("speechbrain_tpu_torch.recipes.LibriSpeech."
                       "self-supervised-learning.wav2vec2.train_sb_wav2vec2")


class CVW2V2Pretrain(ls_w2v.SBW2V2Pretrain):
    """The LibriSpeech twin's Brain (the HF ``Wav2Vec2ForPreTraining``
    objective)."""


def run(hparams, run_opts, brain_cls=CVW2V2Pretrain):
    """``train_sb_wav2vec2.run`` over the CommonVoice corpus."""
    return ls_w2v.run(hparams, run_opts, brain_cls=brain_cls,
                      prepare=prepare_synthetic)


def main(argv=None):
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
