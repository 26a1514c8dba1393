#!/usr/bin/env python
"""VoxCeleb speaker-embedding training on the PyTorch port, the twin of
``recipes/VoxCeleb/SpeakerRec/train_speaker_embeddings.py``: random
fixed-length crops -> Fbank -> an embedding model (ECAPA-TDNN, x-vector or
ResNet, by the YAML) -> the cosine ``Classifier`` -> AAM-softmax over the
speakers, Adam, the cyclic rate set at each valid stage from the optimizer
step, a checkpoint kept by the lowest valid loss.

The crops come from ``np.random.default_rng(seed)``, one draw an
utterance longer than ``sentence_len`` each time the loader reads it, as
in the JAX script: over the same order of reads the two draw the same
crops. (The JAX Brain reads one train batch before training to infer its
parameters' shapes, which spends that batch's draws; the port's modules
are built at their widths and read none.) Evaluate with
``speaker_verification_cosine.py``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing; without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec.train_speaker_embeddings \\
        speechbrain_tpu_torch/recipes/VoxCeleb/SpeakerRec/hparams/train_ecapa_tdnn.yaml \\
        --data_folder=results/voxceleb_data --debug --device=cpu
"""

import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import (
    AdditiveAngularMargin,
    LogSoftmaxWrapper,
    classification_error,
)
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec.prepare import (
    prepare_synthetic,
)


class SpeakerBrain(Brain):
    """Fbank -> embedding model -> cosine classifier -> AAM-softmax."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.loss_fn = LogSoftmaxWrapper(
            AdditiveAngularMargin(margin=0.2, scale=30))

    def compute_forward(self, batch, stage):
        wavs, lens = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        emb = self.modules.embedding_model(feats, lengths=lens)
        return self.modules.classifier(emb)

    def compute_objectives(self, cos, batch, stage):
        spk = batch["spk_id_encoded"].data.reshape(-1)
        loss = self.loss_fn(cos, spk)
        return loss, {"error": classification_error(cos, spk)}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.VALID:
            new_lr = self.hparams.lr_scheduler(self.optimizer_step)
            update_learning_rate(self.optimizer, new_lr)
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch, "lr": new_lr},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def dataio_prepare(hparams):
    """Train and valid datasets of random ``sentence_len`` crops (from
    one generator seeded with ``seed``) and encoded speaker labels; the
    label encoder is built from the train split or loaded from
    ``save_folder``."""
    datasets = {}
    encoder = hparams["label_encoder"]
    chunk = int(hparams["sentence_len"] * hparams["sample_rate"])
    rng = np.random.default_rng(hparams["seed"])

    def chunk_pipeline(wav):
        sig = read_audio(wav)
        if len(sig) > chunk:
            start = int(rng.integers(0, len(sig) - chunk))
            sig = sig[start:start + chunk]
        return sig

    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(chunk_pipeline, takes="wav", provides="sig")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="spk_id",
    )
    for ds in datasets.values():
        ds.add_dynamic_item(lambda spk: encoder.encode_label(spk),
                            takes="spk_id", provides="spk_id_encoded")
        ds.set_output_keys(["id", "sig", "spk_id_encoded"])
    return datasets


def run(hparams, run_opts, brain_cls=SpeakerBrain):
    """The script after the YAML step: datasets, then ``fit`` with Adam at
    ``lr`` and a shuffled train loader of ``batch_size``. Returns the
    Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prepare(hparams)
    lr = hparams["lr"]
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=lambda params: torch.optim.Adam(params, lr=lr),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs={"batch_size": hparams["batch_size"],
                             "shuffle": True},
        valid_loader_kwargs={"batch_size": hparams["batch_size"]},
    )
    return brain


def main(argv=None):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    # the modules the YAML builds go to the Brain's device
    if "device" in run_opts:
        overrides["device"] = run_opts["device"]
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(hparams_file, encoding="utf-8") as f:
        hparams = load_hyperpyyaml(f, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file,
        overrides=overrides,
    )
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
            "debug"):
        prepare_synthetic(hparams["data_folder"],
                          save_folder=Path(hparams["train_annotation"]).parent)
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
