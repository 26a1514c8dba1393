#!/usr/bin/env python
"""LibriSpeech character CTC ASR over a Conformer (or Branchformer)
encoder on the PyTorch port, the twin of
``recipes/LibriSpeech/ASR/CTC/train.py``.

Fbank -> sentence normalisation -> convolutional front end -> the time
axis padded to a multiple of 128 (relative lengths rescaled, so masks and
CTC input lengths stay exact) -> encoder-only ``TransformerASR`` -> CTC
head; the CTC loss over characters (``CTCTextEncoder``, blank ``<blank>``);
AdamW (``optax.adamw``'s defaults) at a fixed rate; batches padded to
multiples of 4800 samples; after every valid stage a line in the train log
and a checkpoint kept by the lowest valid loss. ``ASRCTC.transcribe_batch``
decodes a batch greedily.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing; without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/CTC/hparams/train.yaml \\
        --data_folder=results/ctc_data --debug --device=cpu
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
from speechbrain_tpu_torch.dataio.encoder import CTCTextEncoder
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    adamw,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple

ENC_PAD_MULTIPLE = 128
# waveforms are padded to multiples of 0.3 s (train.py:161-164)
SIG_PAD_MULTIPLE = 4800


class ASRCTC(Brain):
    """The recipe's Brain: waveform -> Fbank -> normalisation -> front end
    -> encoder -> CTC head -> CTC loss over characters."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        feats = self.modules.frontend(feats)
        feats, wav_lens = pad_time_to_multiple(feats, wav_lens,
                                               multiple=ENC_PAD_MULTIPLE)
        enc = self.modules.encoder.encode(feats, wav_len=wav_lens)
        logits = self.modules.ctc_head(enc)
        # the lengths rescaled to the padded frame axis
        return torch.log_softmax(logits.float(), -1), wav_lens

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, enc_lens = predictions
        tokens, tok_lens = batch["tokens"]
        return ctc_loss(p_ctc, tokens, enc_lens, tok_lens,
                        blank_index=self.hparams.blank_index)

    @torch.no_grad()
    def transcribe_batch(self, batch):
        """Greedy CTC transcription of a batch (the modules in
        ``eval()``): a list of character-index lists."""
        self.modules.eval()
        batch = self._prepare_batch(batch)
        logp, enc_lens = self.compute_forward(batch, Stage.TEST)
        return ctc_greedy_decode(logp, enc_lens,
                                 blank_id=self.hparams.blank_index)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            return
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def dataio_prepare(hparams):
    """Manifests -> datasets of audio and character indices (``tokens``);
    the character encoder is made from the train split (or loaded from
    ``save_folder``, as ``char_encoder.txt``), and ``hparams["blank_index"]``
    set to its blank."""
    datasets = {}
    encoder = CTCTextEncoder()
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]}
        )
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(lambda w: list(w), takes="words",
                            provides="char_list")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/char_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="char_list",
        sequence_input=True,
        special_labels={"blank_label": "<blank>"},
    )
    hparams["blank_index"] = encoder.get_blank_index()
    for ds in datasets.values():
        ds.add_dynamic_item(
            lambda cl: np.asarray(
                [int(i) for i in encoder.encode_sequence(cl)], np.int32
            ),
            takes="char_list", provides="tokens",
        )
        ds.set_output_keys(["id", "sig", "tokens"])
    return datasets


def run(hparams, run_opts, brain_cls=ASRCTC):
    """The chain after the YAML step: a synthetic corpus under
    ``run_opts["debug"]`` where the train manifest is missing, the
    character encoder and datasets, ``fit`` with a shuffled train loader.
    Returns ``(brain, datasets)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare_synthetic(
            hparams["data_folder"],
            save_folder=Path(hparams["train_annotation"]).parent,
        )
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prepare(hparams)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adamw(hparams["lr"]),
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
    return brain, datasets


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
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
