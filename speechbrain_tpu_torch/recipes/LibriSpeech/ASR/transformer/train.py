#!/usr/bin/env python
"""LibriSpeech Conformer CTC/attention training on the PyTorch port, the
twin of ``recipes/LibriSpeech/ASR/transformer/train.py``.

Joint CTC + label-smoothed attention objective over BPE targets, Noam
learning rate after every update, AdamW, batches padded to whole seconds,
a checkpoint kept by the lowest valid loss after every valid stage. Beyond
the JAX script, the test split is evaluated after training (the best
checkpoint recovered) and scored by a greedy CTC word error rate.

Run from the repository's root (the corpus is made up under ``--debug``
when its manifest is missing; without ``--device=cpu`` the modules and the
Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transformer/hparams/conformer_small.yaml \\
        --data_folder=results/data --debug --device=cpu

Everything after the YAML step is :func:`run`, which takes a plain dict of
hyperparameters: a machine without a YAML loader builds that dict in
Python (``chip_smoke.py`` does).
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
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.nnet.losses import ctc_loss, kldiv_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

# The encoder's time axis is padded to a multiple of this, as the JAX
# recipe pads it; relative lengths are rescaled, so masks and CTC input
# lengths stay exact.
ENC_PAD_MULTIPLE = 128
# waveforms are padded to whole seconds (train.py:207-209)
SIG_PAD_MULTIPLE = 16000


class ASR(Brain):
    """The recipe's Brain: waveform -> Fbank -> sentence normalisation ->
    convolutional front end -> ``pad_time_to_multiple`` -> TransformerASR
    -> CTC and seq heads -> 0.3 CTC + 0.7 label-smoothed KL; Noam written
    into the optimizer after every applied update; after every valid
    stage a line in the train log and a checkpoint kept by the lowest
    valid loss (each where the Brain has a logger and a checkpointer). In
    the TEST stage the CTC head's output is decoded greedily and scored
    against the batch's ``words`` (``test_stats`` after the stage); this
    needs ``self.tokenizer``."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        tokens_bos, _ = batch["tokens_bos"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        feats = self.modules.frontend(feats)
        feats, wav_lens = pad_time_to_multiple(
            feats, wav_lens, multiple=ENC_PAD_MULTIPLE
        )
        enc, dec = self.modules.model(feats, tokens_bos, wav_len=wav_lens)
        p_ctc = torch.log_softmax(self.modules.ctc_head(enc).float(), -1)
        p_seq = torch.log_softmax(self.modules.seq_head(dec).float(), -1)
        return p_ctc, p_seq, wav_lens

    def compute_objectives(self, predictions, batch, stage):
        p_ctc, p_seq, enc_lens = predictions
        tokens, tok_lens = batch["tokens"]
        tokens_eos, tok_eos_lens = batch["tokens_eos"]
        w = self.hparams.ctc_weight
        loss_ctc = ctc_loss(p_ctc, tokens, enc_lens, tok_lens,
                            blank_index=self.hparams.blank_index)
        loss_seq = kldiv_loss(p_seq, tokens_eos, length=tok_eos_lens,
                              label_smoothing=self.hparams.label_smoothing)
        if stage == Stage.TEST:
            hyps = ctc_greedy_decode(p_ctc, enc_lens,
                                     blank_id=self.hparams.blank_index)
            self.wer_metric.append(
                batch.id, ids_to_words(self.tokenizer, hyps),
                [words.split() for words in batch.words],
            )
        return w * loss_ctc + (1 - w) * loss_seq

    def on_fit_batch_end(self, batch, outputs, loss, should_step):
        # Noam after every applied update: the first runs at lr_adam
        if should_step:
            _, new_lr = self.hparams.noam_scheduler(None)
            update_learning_rate(self.optimizer, new_lr)

    def on_stage_start(self, stage, epoch=None):
        if stage == Stage.TEST:
            self.wer_metric = ErrorRateStats()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            return
        if stage == Stage.TEST:
            wer = self.wer_metric.summarize()
            self.test_stats = {"loss": stage_loss, "WER": wer["WER"],
                               "num_ref_tokens": wer["num_scored_tokens"]}
            if hasattr(self.hparams, "train_logger"):
                self.hparams.train_logger.log_stats(
                    stats_meta={"epoch loaded":
                                self.hparams.epoch_counter.current},
                    test_stats=self.test_stats, verbose=False,
                )
            return
        self.log_stats(stage_loss, epoch)
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])

    def log_stats(self, stage_loss, epoch):
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch,
                            "lr": self.hparams.noam_scheduler.current_lr},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )


def ids_to_words(tokenizer, hyps):
    """Token id lists -> word lists. BPE training stops where the corpus
    has no pair left to merge, so the tokenizer may hold fewer pieces than
    the model's head has classes (5000): an id past its pieces decodes as
    its unknown piece."""
    n_pieces = tokenizer.sp.vocab_size()
    unk = tokenizer.sp.piece_to_id("<unk>")
    return [tokenizer.decode_ids([i if i < n_pieces else unk for i in h])
            .split() for h in hyps]


def dataio_prepare(hparams, tokenizer):
    """Manifests -> datasets that read the audio and encode the words
    into BPE ids (``tokens``, ``tokens_bos``, ``tokens_eos``), the words
    kept beside them for scoring. The train split is sorted by length; a
    missing test manifest is skipped."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation"),
                       ("test", "test_annotation")):
        path = hparams[key]
        if not Path(path).exists():
            if split == "test":
                continue
            raise FileNotFoundError(
                f"{path} missing; run librispeech_prepare.py first"
            )
        ds = DynamicItemDataset.from_json(
            path, replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def tokens_pipeline(words):
            ids = tokenizer.sp.encode_as_ids(words)
            yield np.asarray(ids, np.int32)
            yield np.asarray([hparams["bos_index"]] + ids, np.int32)
            yield np.asarray(ids + [hparams["eos_index"]], np.int32)

        ds.add_dynamic_item(
            tokens_pipeline, takes="words",
            provides=["tokens", "tokens_bos", "tokens_eos"],
        )
        ds.set_output_keys(
            ["id", "sig", "tokens", "tokens_bos", "tokens_eos", "words"]
        )
        datasets[split] = ds
    return datasets


def adamw(lr):
    """The recipe's optimizer, ``optax.adamw`` at ``lr`` with its
    defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
    parameter (``torch.optim.AdamW`` would default to 1e-2)."""
    return lambda params: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
    )


def run(hparams, run_opts, brain_cls=ASR):
    """The chain after the YAML step: a synthetic corpus under
    ``run_opts["debug"]`` where the train manifest is missing, the
    tokenizer (trained on the train manifest's words, or loaded from
    ``save_folder``), the datasets, ``fit`` with a shuffled train loader,
    then the test split's loss and WER. ``brain_cls`` is :class:`ASR` or a
    subclass of it. Returns ``(brain, datasets, tokenizer)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare_synthetic(
            hparams["data_folder"],
            save_folder=Path(hparams["train_annotation"]).parent,
        )
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["vocab_size"],
        annotation_train=hparams["train_annotation"],
        annotation_read="words",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    datasets = dataio_prepare(hparams, tokenizer)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adamw(hparams["lr_adam"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    brain.tokenizer = tokenizer
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": SIG_PAD_MULTIPLE}}
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs=dict(loader, shuffle=True),
        valid_loader_kwargs=loader,
    )
    if "test" in datasets:
        brain.evaluate(datasets["test"], min_key="loss",
                       test_loader_kwargs=loader)
    return brain, datasets, tokenizer


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
