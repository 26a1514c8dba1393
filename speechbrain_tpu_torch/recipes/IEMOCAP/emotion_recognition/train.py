#!/usr/bin/env python
"""IEMOCAP speech emotion recognition on the PyTorch port, the twin of
``recipes/IEMOCAP/emotion_recognition/train.py``: the CommonLanguage
script with the emotion (``emo``) as its label, so the twin runs the
CommonLanguage twin's ``LangIdBrain`` under that key. ``train_ecapa.yaml``
embeds with ECAPA-TDNN, ``train_xvector.yaml`` with an x-vector; both
classify with ECAPA's cosine ``Classifier``.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.IEMOCAP.emotion_recognition.train \\
        speechbrain_tpu_torch/recipes/IEMOCAP/emotion_recognition/hparams/train_ecapa.yaml \\
        --data_folder=results/iemocap_data --debug --device=cpu
"""

import functools
import sys

from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id import (
    train as common_language,
)
from speechbrain_tpu_torch.recipes.IEMOCAP.emotion_recognition.prepare import (  # noqa: E501
    prepare_synthetic,
)

EmoBrain = common_language.LangIdBrain
run = functools.partial(common_language.run, label_key="emo")


def main(argv=None):
    return common_language.main(argv, run_fn=run,
                                prepare_corpus=prepare_synthetic)


if __name__ == "__main__":
    main(sys.argv[1:])
