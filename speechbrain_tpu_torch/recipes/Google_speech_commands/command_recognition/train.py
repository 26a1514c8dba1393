#!/usr/bin/env python
"""Google Speech Commands keyword classification on the PyTorch port, the
twin of ``recipes/Google-speech-commands/command_recognition/train.py``:
features -> an embedding model -> a classifier over the commands, Adam, a
checkpoint kept by the lowest valid loss.

The features are the YAML's ``compute_features``: a fixed ``Fbank``, or,
where ``modules`` names one (``xvect_leaf.yaml``), a learnable front end
trained with the model. The objective is NLL over the x-vector
classifier's log-probabilities, or the YAML's ``compute_cost`` where it
names one: ``ecapa.yaml`` trains its cosine classifier by AAM-softmax, as
the speaker recipes do. (The JAX script takes ``[:, 0]`` of every
classifier's output and hands it to ``nll_loss``; the ECAPA classifier's
output is (batch, classes), so that is the first class's cosine, and
``nll_loss`` raises on it: ROADMAP C40.)

Run from the repository's root (a synthetic command set is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.Google_speech_commands.command_recognition.train \\
        speechbrain_tpu_torch/recipes/Google_speech_commands/command_recognition/hparams/xvector.yaml \\
        --data_folder=results/gsc_data --debug --device=cpu
"""

import sys
from pathlib import Path

import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import classification_error, nll_loss
from speechbrain_tpu_torch.recipes.Google_speech_commands.command_recognition.prepare import (  # noqa: E501
    prepare_synthetic,
)


class CommandBrain(Brain):
    """Features -> embedding model -> classifier -> NLL (or the YAML's
    ``compute_cost``)."""

    def compute_forward(self, batch, stage):
        wavs, _ = batch["sig"]
        if "compute_features" in self.modules:
            feats = self.modules.compute_features(wavs)
        else:
            feats = self.hparams.compute_features(wavs)
        out = self.modules.classifier(self.modules.embedding_model(feats))
        return out[:, 0] if out.ndim == 3 else out

    def compute_objectives(self, out, batch, stage):
        cmd = batch["command_encoded"].data.reshape(-1)
        cost = getattr(self.hparams, "compute_cost", None)
        loss = cost(out, cmd) if cost is not None else nll_loss(out, cmd)
        return loss, {"error": classification_error(out, cmd)}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.VALID:
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def dataio_prepare(hparams):
    """Train and valid datasets of whole utterances and encoded commands;
    the label encoder is built from the train split or loaded from
    ``save_folder``."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="command",
    )
    for ds in datasets.values():
        ds.add_dynamic_item(lambda c: encoder.encode_label(c),
                            takes="command", provides="command_encoded")
        ds.set_output_keys(["id", "sig", "command_encoded"])
    return datasets


def run(hparams, run_opts, brain_cls=CommandBrain):
    """The script after the YAML step: datasets, then ``fit`` with Adam at
    ``lr`` and a shuffled train loader. Returns the Brain."""
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
        prepare_synthetic(hparams["data_folder"])
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
