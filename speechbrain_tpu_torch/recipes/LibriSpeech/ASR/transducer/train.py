#!/usr/bin/env python
"""LibriSpeech Conformer transducer (RNN-T) training on the PyTorch port,
the twin of ``recipes/LibriSpeech/ASR/transducer/train.py``.

Fbank -> sentence normalisation -> convolutional front end -> the time
axis padded to a multiple of 128 -> encoder-only ``TransformerASR``
(Conformer) -> ``enc_proj``; the prediction network (embedding -> LSTM ->
``dec_proj``) over the blank-prefixed targets; the additive joint ->
``out`` -> log-softmax; the transducer loss, mixed with an auxiliary CTC
loss on ``enc_proj``'s output at ``ctc_weight``. AdamW (``optax.adamw``'s
defaults) annealed by NewBob on the valid loss; batches padded to whole
seconds; a checkpoint kept by the lowest valid loss after every valid
stage. ``TransducerASR.make_searcher`` and ``transcribe_batch`` serve the
trained model through ``decoders/transducer.py`` (greedy or beam search,
optionally fused with an RNN language model).

With ``streaming`` set (``conformer_transducer_streaming.yaml``: dynamic
chunk training), every batch is encoded under the configuration that
``dynchunktrain_config_sampler(stage)`` draws, as the JAX recipe does:
chunked or full context in training, the YAML's ``valid_config`` and
``test_config`` otherwise.

The TIMIT, CommonVoice, GigaSpeech and VoxPopuli transducer twins run this
module's Brain and ``run`` with their own data preparation and labels.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing; without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transducer/hparams/conformer_transducer.yaml \\
        --data_folder=results/rnnt_data --debug --device=cpu
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
from speechbrain_tpu_torch.decoders.transducer import TransducerBeamSearcher
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.nnet.transducer_loss import transducer_loss
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    adamw,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple

# the encoder's time axis is padded to a multiple of this, as the JAX
# recipe pads it; relative lengths are rescaled
ENC_PAD_MULTIPLE = 128
# waveforms are padded to whole seconds (train.py:227-230)
SIG_PAD_MULTIPLE = 16000


class TransducerASR(Brain):
    """The recipe's Brain: Conformer encoder, LSTM prediction network,
    additive joint, transducer loss (+ CTC at ``ctc_weight``); after every
    valid stage NewBob anneals the optimizer's rate on the valid loss, a
    line goes to the train log and a checkpoint is kept by the lowest
    valid loss (each where the Brain has a logger and a checkpointer)."""

    def chunk_config(self, stage):
        """The stage's dynamic chunk configuration: drawn from
        ``dynchunktrain_config_sampler`` where ``streaming`` is set (a
        draw a training batch), else None (full context)."""
        if getattr(self.hparams, "streaming", False):
            return self.hparams.dynchunktrain_config_sampler(stage)
        return None

    def encode(self, wavs, wav_lens, dynchunktrain_config=None):
        """Waveforms -> ``enc_proj`` of the encoder states (B, T', joint)
        and their relative lengths over the padded T'."""
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        feats = self.modules.frontend(feats)
        feats, wav_lens = pad_time_to_multiple(feats, wav_lens,
                                               multiple=ENC_PAD_MULTIPLE)
        enc = self.modules.encoder.encode(
            feats, wav_len=wav_lens, dynchunktrain_config=dynchunktrain_config)
        return self.modules.enc_proj(enc), wav_lens

    def predict(self, tokens, hidden=None):
        """The prediction network: tokens (B, U) -> (``dec_proj`` of the
        LSTM's output (B, U, joint), the LSTM's state)."""
        out, hidden = self.modules.dec(self.modules.emb(tokens), hidden)
        return self.modules.dec_proj(out), hidden

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        tokens, _ = batch["tokens"]
        enc, enc_lens = self.encode(wavs, wav_lens, self.chunk_config(stage))
        blank = self.hparams.blank_index
        pn_in = torch.cat([torch.full_like(tokens[:, :1], blank), tokens],
                          dim=1)
        pn, _ = self.predict(pn_in)
        joint = self.modules.joint(enc[:, :, None, :], pn[:, None, :, :])
        logits = self.modules.out(joint)
        outputs = [torch.log_softmax(logits.float(), -1), enc_lens]
        if self.hparams.ctc_weight > 0:
            outputs.append(torch.log_softmax(
                self.modules.ctc_head(enc).float(), -1))
        return tuple(outputs)

    def compute_objectives(self, predictions, batch, stage):
        logp, enc_lens, *rest = predictions
        tokens, tok_lens = batch["tokens"]
        loss = transducer_loss(logp, tokens, enc_lens, tok_lens,
                               self.hparams.blank_index)
        if rest:
            loss_ctc = ctc_loss(rest[0], tokens, enc_lens, tok_lens,
                                blank_index=self.hparams.blank_index)
            w = self.hparams.ctc_weight
            loss = (1 - w) * loss + w * loss_ctc
        return loss

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        if hasattr(self.hparams, "train_logger"):
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch, "lr": old_lr},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
        if self.checkpointer is not None:
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])

    def make_searcher(self, beam_size=1, lm=None, **kwargs):
        """A ``TransducerBeamSearcher`` over the trained modules: greedy at
        ``beam_size`` 1; ``lm`` (an ``RNNLM``, ``lm(tokens, hidden) ->
        (logits, hidden)``) is fused at ``lm_weight``; ``kwargs`` go to the
        searcher (``nbest``, ``lm_weight``, ``state_beam``,
        ``expand_beam``, ``max_symbols_per_step``)."""
        return TransducerBeamSearcher(
            self.predict, self.modules.joint, self.modules.out,
            blank_id=self.hparams.blank_index, beam_size=beam_size,
            lm_module=lm, **kwargs,
        )

    @torch.no_grad()
    def transcribe_batch(self, wavs, wav_lens, searcher):
        """Encode (the modules in ``eval()``; a streaming model under its
        test configuration) and search: the searcher gets the encoder
        frames up to the longest row's last valid one, so that no frame of
        the padding to a multiple of 128 is decoded (the searcher itself
        takes no lengths). Returns the searcher's result."""
        self.modules.eval()
        enc, enc_lens = self.encode(wavs, wav_lens,
                                    self.chunk_config(Stage.TEST))
        n = int(round(float(enc_lens.max()) * enc.shape[1]))
        return searcher(enc[:, :n])


def dataio_prepare(hparams, encode_labels, takes="words"):
    """Manifests -> datasets that read the audio and encode each
    utterance's ``takes`` entry into label ids (``tokens``) through
    ``encode_labels``. The train split is sorted by length."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(encode_labels, takes=takes, provides="tokens")
        ds.set_output_keys(["id", "sig", "tokens"])
        datasets[split] = ds
    return datasets


def bpe_labels(hparams):
    """The YAML's SentencePiece model, trained on the train manifest's
    words: ``(tokenizer, the manifest entry it reads, words -> ids)``."""
    tokenizer = SentencePiece(
        model_dir=hparams["save_folder"],
        vocab_size=hparams["vocab_size"],
        annotation_train=hparams["train_annotation"],
        annotation_read="words",
        model_type=hparams["token_type"],
        annotation_format="json",
    )
    return tokenizer, "words", lambda words: np.asarray(
        tokenizer.sp.encode_as_ids(words), np.int32)


def prepare_librispeech_synthetic(hparams):
    prepare_synthetic(hparams["data_folder"],
                      save_folder=Path(hparams["train_annotation"]).parent)


def run(hparams, run_opts, brain_cls=TransducerASR,
        prepare=prepare_librispeech_synthetic, labels=bpe_labels,
        pad_to_multiple=None):
    """The chain after the YAML step: a synthetic corpus under
    ``run_opts["debug"]`` where the train manifest is missing
    (``prepare(hparams)``), the labels (``labels(hparams)`` -> ``(label
    encoder, manifest entry, text -> ids)``), the datasets, ``fit`` with a
    shuffled train loader; batches padded to whole seconds and as
    ``pad_to_multiple`` (``{key: multiple}``) says. Returns ``(brain,
    datasets, label encoder)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare(hparams)
    tokenizer, takes, encode_labels = labels(hparams)
    datasets = dataio_prepare(hparams, encode_labels, takes)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adamw(hparams["lr"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": SIG_PAD_MULTIPLE,
                                  **(pad_to_multiple or {})}}
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs=dict(loader, shuffle=True),
        valid_loader_kwargs=loader,
    )
    return brain, datasets, tokenizer


def main(argv=None, **run_kwargs):
    """The YAML step (``argv`` as on the command line), then ``run`` with
    ``run_kwargs``."""
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
    return run(hparams, run_opts, **run_kwargs)


if __name__ == "__main__":
    main(sys.argv[1:])
