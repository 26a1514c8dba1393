#!/usr/bin/env python
"""TIMIT Conformer transducer (RNN-T) phoneme recognition on the PyTorch
port, the twin of ``recipes/TIMIT/ASR/transducer/train.py``: the
LibriSpeech transducer twin's Brain and ``run`` over TIMIT's manifests,
with phone ids from a map built over the train manifest's phones (blank
0) in place of a tokenizer.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.TIMIT.ASR.transducer.train \\
        speechbrain_tpu_torch/recipes/TIMIT/ASR/transducer/hparams/conformer_transducer.yaml \\
        --data_folder=results/timit_data --debug --device=cpu
"""

import json
import sys

import numpy as np

from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train import (
    main,
)
from speechbrain_tpu_torch.recipes.TIMIT.timit_prepare import (
    prepare_synthetic,
)


def build_phone_map(hparams):
    """``{phone: id}`` over the train manifest's phones, sorted, from 1
    (0 is the blank)."""
    with open(hparams["train_annotation"], encoding="utf-8") as f:
        items = json.load(f)
    phones = sorted({p for e in items.values() for p in e["phn"].split()})
    return {p: i + 1 for i, p in enumerate(phones)}


def phone_labels(hparams):
    """``(phone map, "phn", phones -> ids)``; a phone the map lacks is
    id 1, as in the JAX recipe."""
    phone_map = build_phone_map(hparams)
    return phone_map, "phn", lambda phn: np.asarray(
        [phone_map.get(p, 1) for p in phn.split()], np.int32)


def prepare(hparams):
    prepare_synthetic(hparams["data_folder"])


if __name__ == "__main__":
    main(sys.argv[1:], prepare=prepare, labels=phone_labels)
