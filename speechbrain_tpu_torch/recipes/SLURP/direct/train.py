#!/usr/bin/env python
"""SLURP "direct" spoken language understanding on the PyTorch port, the
twin of ``recipes/SLURP/direct/train.py``: speech -> the serialized
semantics (scenario, action, entities as a dict string) by a CRDNN
encoder and a GRU decoder with key-value attention over BPE tokens of the
semantics; label-smoothed NLL only (no CTC head), Adam annealed by
NewBob on the valid loss, batches padded to a multiple of 4096 samples.

Served by ``inference/SLU.EndToEndSLU`` over ``slu_encoder`` (Fbank ->
sentence normalisation -> CRDNN) and ``slu_searcher`` (an
``S2SRNNBeamSearcher`` over the embedding, decoder and head, BOS = EOS =
0).

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.SLURP.direct.train \\
        speechbrain_tpu_torch/recipes/SLURP/direct/hparams/train.yaml \\
        --data_folder=results/slurp_data --debug --device=cpu
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
from speechbrain_tpu_torch.nnet.containers import LengthsCapableSequential
from speechbrain_tpu_torch.nnet.losses import nll_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq.train import (
    RNNSearchDecoder,
)
from speechbrain_tpu_torch.recipes.SLURP.direct.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece

# waveforms are padded to a multiple of this many samples (train.py:155)
SIG_PAD_MULTIPLE = 4096
# the served search's beam
SLU_BEAM_SIZE = 8


class SLU(Brain):
    """Fbank -> sentence normalisation -> CRDNN -> embedding of BOS +
    tokens -> attentional GRU decoder -> head -> log-softmax -> NLL. After
    every valid stage NewBob anneals the rate, a line goes to the train
    log and a checkpoint is kept by the lowest valid loss."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        tokens_bos, _ = batch["tokens_bos"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        enc = self.modules.enc(feats)
        dec_out, _ = self.modules.dec(self.modules.emb(tokens_bos), enc,
                                      wav_lens)
        return torch.log_softmax(self.modules.seq_lin(dec_out).float(), -1)

    def compute_objectives(self, predictions, batch, stage):
        tokens_eos, tok_lens = batch["tokens_eos"]
        return nll_loss(predictions, tokens_eos, length=tok_lens,
                        label_smoothing=self.hparams.label_smoothing)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch, "lr": old_lr},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def slu_encoder(hparams):
    """The served encoder: ``(wavs, relative lengths) -> CRDNN states``
    over the run's feature, normalisation and encoder objects."""
    return LengthsCapableSequential([hparams["compute_features"],
                                     hparams["normalize"], hparams["enc"]])


def slu_searcher(hparams, max_decode_ratio=1.0):
    """The served search: an ``S2SRNNBeamSearcher`` of ``SLU_BEAM_SIZE``
    over the trained embedding, decoder and head (``RNNSearchDecoder``),
    from BOS to EOS."""
    return RNNSearchDecoder(
        hparams["emb"], hparams["dec"], hparams["seq_lin"],
        beam_size=SLU_BEAM_SIZE, bos_index=hparams["bos_index"],
        eos_index=hparams["eos_index"], min_decode_ratio=0.0,
        max_decode_ratio=max_decode_ratio)


def dataio_prepare(hparams, tokenizer):
    """Train and valid datasets that read the audio and encode the
    semantics string into BPE ids (``tokens_bos``, ``tokens_eos``)."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def tokens_pipeline(semantics):
            ids = tokenizer.sp.encode_as_ids(semantics)
            yield np.asarray([hparams["bos_index"]] + ids, np.int32)
            yield np.asarray(ids + [hparams["eos_index"]], np.int32)

        ds.add_dynamic_item(tokens_pipeline, takes="semantics",
                            provides=["tokens_bos", "tokens_eos"])
        ds.set_output_keys(["id", "sig", "tokens_bos", "tokens_eos"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=SLU):
    """The chain after the YAML step: a synthetic corpus under ``--debug``
    where the train manifest is missing, the BPE tokenizer over the
    semantics, the datasets, ``fit`` with Adam at ``lr``. Returns
    ``(brain, datasets, tokenizer)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
            "debug"):
        prepare_synthetic(hparams["data_folder"])
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["output_neurons"],
        annotation_train=hparams["train_annotation"],
        annotation_read="semantics",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    datasets = dataio_prepare(hparams, tokenizer)
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
    brain.fit(hparams["epoch_counter"], datasets["train"], datasets["valid"],
              train_loader_kwargs=dict(loader, shuffle=True),
              valid_loader_kwargs=loader)
    return brain, datasets, tokenizer


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
    return run(hparams, run_opts)


if __name__ == "__main__":
    main(sys.argv[1:])
