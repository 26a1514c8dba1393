#!/usr/bin/env python
"""DVoice (African languages) character CTC over the wav2vec 2.0 encoder
stack on the PyTorch port, the twin of
``recipes/DVoice/ASR/CTC/train_with_wav2vec2.py``: the LibriSpeech twin's
``W2VCTC`` chain (``recipes/LibriSpeech/ASR/CTC/train_with_wav2vec.py``)
over the DVoice corpus (``prepare.py``). Its seven YAMLs differ only in
their output folders and the ``language`` they name.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.DVoice.ASR.CTC.train_with_wav2vec2 \\
        speechbrain_tpu_torch/recipes/DVoice/ASR/CTC/hparams/train_with_wav2vec2.yaml \\
        --data_folder=results/dvoice_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.DVoice.ASR.CTC.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train_with_wav2vec as ls_w2v_ctc,
)


def run(hparams, run_opts, brain_cls=ls_w2v_ctc.W2VCTC):
    """The LibriSpeech twin's ``run`` over the DVoice corpus."""
    return ls_w2v_ctc.run(hparams, run_opts, brain_cls=brain_cls,
                          prepare=prepare_synthetic)


def main(argv=None):
    return run(*ls_w2v_ctc.load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
