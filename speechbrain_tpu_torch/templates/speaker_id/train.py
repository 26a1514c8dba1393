#!/usr/bin/env python
"""Speaker-identification training template on the PyTorch port, the twin
of ``templates/speaker_id/train.py``: Fbank -> ECAPA-TDNN -> the cosine
``Classifier`` -> AAM-softmax, Adam, a checkpoint kept by the lowest valid
loss after every valid stage.

Beyond the JAX script, the best checkpoint is exported after training
(``utils/pretrained.save_for_pretrained``) into ``pretrained_folder``
beside a ``hyperparams.yaml`` made from ``inference.yaml``, so that

    EncoderClassifier.from_hparams(source=<pretrained_folder>)

serves what was trained (``classify_batch``, ``classify_file``,
``encode_batch``).

Expects JSON manifests ``{utt: {"wav": path, "spk_id": label, "length":
seconds}}``. Run from the repository's root (without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.templates.speaker_id.train \\
        speechbrain_tpu_torch/templates/speaker_id/train.yaml \\
        --data_folder=/path/to/data --device=cpu
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
from speechbrain_tpu_torch.nnet.losses import (
    AdditiveAngularMargin,
    LogSoftmaxWrapper,
    classification_error,
)
from speechbrain_tpu_torch.utils.pretrained import save_for_pretrained

# waveforms are padded to a multiple of this many samples (train.py:125-129)
SIG_PAD_MULTIPLE = 2048
# the hparams that fix the exported model's architecture
ARCHITECTURE_KEYS = ("sample_rate", "n_mels", "emb_dim", "n_classes")
INFERENCE_YAML = Path(__file__).with_name("inference.yaml")


class SpeakerBrain(Brain):
    """Fbank -> ECAPA -> AAM-softmax."""

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
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def dataio_prep(hparams):
    """Manifests -> datasets that read the audio and encode the speaker;
    the label encoder is built from the train split or loaded from
    ``save_folder``."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, ann in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[ann], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
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


def export(hparams):
    """The best checkpoint's embedding model, classifier and label encoder
    into ``pretrained_folder``, with ``inference.yaml`` at this run's
    architecture as its ``hyperparams.yaml``; returns the folder."""
    from speechbrain_tpu_torch.utils.hyperyaml import resolve_yaml

    folder = Path(hparams["pretrained_folder"])
    save_for_pretrained(hparams, min_key="loss")
    text = resolve_yaml(INFERENCE_YAML.read_text(encoding="utf-8"),
                        {k: hparams[k] for k in ARCHITECTURE_KEYS})
    (folder / "hyperparams.yaml").write_text(text, encoding="utf-8")
    return folder


def run(hparams, run_opts, brain_cls=SpeakerBrain):
    """The template after the YAML step: datasets, ``fit`` with Adam at
    ``lr`` and a shuffled train loader, then the export. Returns the
    Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prep(hparams)
    lr = hparams["lr"]
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=lambda params: torch.optim.Adam(params, lr=lr),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": SIG_PAD_MULTIPLE}}
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs=dict(loader, shuffle=True),
        valid_loader_kwargs=loader,
    )
    export(hparams)
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
    run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
