#!/usr/bin/env python
"""Speech-recognition training template on the PyTorch port, the twin of
``templates/speech_recognition/train.py``: Fbank -> sentence
normalisation -> Conformer encoder -> CTC head over characters, Adam, a
checkpoint kept by the lowest valid loss after every valid stage.

The JAX template's ``evaluate_batch_extra`` and the WER metric it makes
for the valid stage are used nowhere there and are left out here. Beyond
the JAX script, the best checkpoint is exported after training
(``utils/pretrained.save_for_pretrained``) into ``pretrained_folder``
beside a ``hyperparams.yaml`` made from ``inference.yaml``, so that

    EncoderASR.from_hparams(source=<pretrained_folder>)

serves what was trained.

Expects JSON manifests ``{utt: {"wav": path, "words": str, "length":
seconds}}``. Run from the repository's root (without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.templates.speech_recognition.train \\
        speechbrain_tpu_torch/templates/speech_recognition/train.yaml \\
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
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.utils.pretrained import save_for_pretrained

# waveforms are padded to a multiple of this many samples (train.py:140-142)
SIG_PAD_MULTIPLE = 4096
# the hparams that fix the exported model's architecture
ARCHITECTURE_KEYS = ("sample_rate", "n_mels", "d_model", "nhead",
                     "num_layers", "d_ffn", "output_neurons", "blank_index")
INFERENCE_YAML = Path(__file__).with_name("inference.yaml")


class ASRBrain(Brain):
    """Fbank -> Conformer encoder -> CTC head."""

    def compute_forward(self, batch, stage):
        wavs, lens = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, lens)
        enc = self.modules.encoder.encode(feats, wav_len=lens)
        return torch.log_softmax(self.modules.ctc_head(enc), -1)

    def compute_objectives(self, predictions, batch, stage):
        _, wav_lens = batch["sig"]
        chars, char_lens = batch["char_encoded"]
        return ctc_loss(predictions, chars, wav_lens, char_lens,
                        blank_index=self.hparams.blank_index)

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
    """Manifests -> datasets that read the audio and encode the words
    character by character; the label encoder is built from the train
    split (blank at index 0) or loaded from ``save_folder``."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, ann in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[ann], replacements={"data_root": hparams["data_folder"]},
        )
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(lambda words: list(words), takes="words",
                            provides="char_list")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="char_list",
        sequence_input=True,
        special_labels={"blank_label": hparams["blank_index"]},
    )
    for ds in datasets.values():
        ds.add_dynamic_item(encoder.encode_sequence_array,
                            takes="char_list", provides="char_encoded")
        ds.set_output_keys(["id", "sig", "char_encoded"])
    return datasets


def export(hparams):
    """The best checkpoint's encoder, CTC head and label encoder into
    ``pretrained_folder``, with ``inference.yaml`` at this run's
    architecture as its ``hyperparams.yaml``; returns the folder."""
    from speechbrain_tpu_torch.utils.hyperyaml import resolve_yaml

    folder = Path(hparams["pretrained_folder"])
    save_for_pretrained(hparams, min_key="loss")
    text = resolve_yaml(INFERENCE_YAML.read_text(encoding="utf-8"),
                        {k: hparams[k] for k in ARCHITECTURE_KEYS})
    (folder / "hyperparams.yaml").write_text(text, encoding="utf-8")
    return folder


def run(hparams, run_opts, brain_cls=ASRBrain):
    """The template after the YAML step: datasets, ``fit`` with Adam at
    ``lr`` and a shuffled train loader, then the export. ``brain_cls`` is
    :class:`ASRBrain` or a subclass of it. Returns the Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prep(hparams)
    lr = hparams["lr"]
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=lambda params: torch.optim.Adam(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
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
