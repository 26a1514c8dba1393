#!/usr/bin/env python
"""VoxLingua107 spoken language identification on the PyTorch port, the
twin of ``recipes/VoxLingua107/lang_id/train.py``, which is the
CommonLanguage script over another corpus: the CommonLanguage twin's
``LangIdBrain`` and ``run`` with this corpus's synthetic languages.

Run from the repository's root:

    python -m speechbrain_tpu_torch.recipes.VoxLingua107.lang_id.train \\
        speechbrain_tpu_torch/recipes/VoxLingua107/lang_id/hparams/train_ecapa.yaml \\
        --data_folder=results/vl_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id import (
    train as common_language,
)
from speechbrain_tpu_torch.recipes.VoxLingua107.lang_id.prepare import (
    prepare_synthetic,
)

LangIdBrain = common_language.LangIdBrain
run = common_language.run


def main(argv=None):
    return common_language.main(argv, prepare_corpus=prepare_synthetic)


if __name__ == "__main__":
    main(sys.argv[1:])
