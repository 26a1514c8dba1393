#!/usr/bin/env python
"""LibriSpeech character CTC over the wav2vec 2.0 encoder stack on the
PyTorch port, the twin of ``recipes/LibriSpeech/ASR/CTC/train_with_wav2vec.py``.

Waveform -> ``W2VLatentExtractor`` -> latent projection -> Transformer
encoder (the frames past each relative length masked as padding, ``round(len
* T)`` of them kept) -> CTC head; the CTC loss over characters (the YAML's
``label_encoder``, blank at ``blank_index``). AdamW (``optax.adamw``'s
defaults) at ``lr``, annealed by NewBob after every valid stage, which logs
and keeps a checkpoint by the lowest valid loss. ``W2VCTC.transcribe_batch``
decodes a batch greedily. The DVoice twin runs this chain with its own
corpus.

N-best rescoring (``train_hf_wav2vec_{rnn,transformer}_rescoring.yaml``):
where the YAML names a ``rescorer_lm``, :func:`build_rescorer` wraps it
(``rescorer_type`` ``rnn`` or ``transformer``) in a ``RescorerBuilder`` at
``rescorer_weight``, and each valid or test batch is also decoded by the
YAML's ``test_beam_searcher`` (the host CTC beam search, ``topk``
hypotheses), reranked by the LM, and its best hypotheses scored into the
stage's CER. The LM's weights are its random init here; a real run pours a
trained LM in.

Not ported: the JAX script's input downsampler (the ``downsampled/`` YAMLs,
ROADMAP item 16); no YAML of this folder's twins reaches it.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/CTC/hparams/train_with_wav2vec.yaml \\
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
from speechbrain_tpu_torch.dataio.dataio import length_to_mask, read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.decoders.scorer import (
    RescorerBuilder,
    RNNLMRescorer,
    TransformerLMRescorer,
)
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.utils.autocast import autocast
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    adamw,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)

# waveforms are padded to multiples of 1 s (train_with_wav2vec.py:252-255)
SIG_PAD_MULTIPLE = 16000


class W2VCTC(Brain):
    """W2V latent extractor -> Transformer encoder -> character CTC."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        lat = self.modules.latent_proj(self.modules.extractor(wavs))
        T = lat.shape[1]
        pad_mask = ~length_to_mask(torch.round(wav_lens * T), max_len=T)
        enc, _ = self.modules.encoder(lat, src_key_padding_mask=pad_mask)
        logits = self.modules.ctc_head(enc)
        return torch.log_softmax(logits.float(), -1)

    def compute_objectives(self, p_ctc, batch, stage):
        _, wav_lens = batch["sig"]
        chars, char_lens = batch["char_encoded"]
        return ctc_loss(p_ctc, chars, wav_lens, char_lens,
                        blank_index=self.hparams.blank_index)

    @torch.no_grad()
    def transcribe_batch(self, batch):
        """Greedy CTC transcription of a batch (the modules in
        ``eval()``): a list of character-index lists."""
        self.modules.eval()
        batch = self._prepare_batch(batch)
        logp = self.compute_forward(batch, Stage.TEST)
        return ctc_greedy_decode(logp, batch["sig"][1],
                                 blank_id=self.hparams.blank_index)

    def on_stage_start(self, stage, epoch=None):
        if stage != Stage.TRAIN:
            self.cer_metric = ErrorRateStats(space_token=" ")

    @torch.no_grad()
    def evaluate_batch(self, batch, stage):
        """The loss of a valid or test batch; where the YAML wires a
        ``test_beam_searcher`` and :func:`build_rescorer` a ``rescorer``,
        also the CTC posteriors of the same forward decoded into ``topk``
        hypotheses on the host, reranked by the LM, and the best of each
        scored into ``cer_metric``."""
        searcher = getattr(self.hparams, "test_beam_searcher", None)
        rescorer = getattr(self.hparams, "rescorer", None)
        if searcher is None or rescorer is None:
            return super().evaluate_batch(batch, stage)
        batch = self._prepare_batch(batch)
        with autocast(self.run_opts.eval_precision, self.device):
            logp = self.compute_forward(batch, stage)
        loss, _ = self._objectives(logp, batch, stage)
        topk = searcher(logp, batch["sig"][1])
        hyps = [[list(beam.text) for beam in row] for row in topk]
        scores = [[float(beam.score) for beam in row] for row in topk]
        best, _, _ = rescorer.rescore(hyps, scores)
        chars, char_lens = batch["char_encoded"]
        self.cer_metric.append(batch["id"], [[int(t) for t in h]
                                             for h in best],
                               chars, target_len=char_lens)
        return float(loss)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        valid_stats = {"loss": stage_loss}
        if getattr(self, "cer_metric", None) and self.cer_metric.ids:
            valid_stats["CER"] = self.cer_metric.summarize("error_rate")
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch, "lr": old_lr},
            train_stats={"loss": self.train_loss},
            valid_stats=valid_stats, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def build_rescorer(hparams):
    """The YAML's ``rescorer_lm`` (in ``eval()``) as a ``RescorerBuilder``
    of one rescorer ``"lm"`` at ``rescorer_weight`` (0.5 where unset): an
    ``RNNLMRescorer`` from a zero state where ``rescorer_type`` is
    ``"rnn"`` (the default), else a ``TransformerLMRescorer``; bos and eos
    from the YAML, on the LM's device."""
    lm = hparams["rescorer_lm"].eval()
    device = next(lm.parameters()).device
    ids = dict(bos_index=hparams["bos_index"],
               eos_index=hparams["eos_index"], device=device)
    if hparams.get("rescorer_type", "rnn") == "rnn":
        impl = RNNLMRescorer(lambda tokens, state: lm(tokens, hx=state),
                             lambda n: None, **ids)
    else:
        impl = TransformerLMRescorer(lm, **ids)
    return RescorerBuilder(weights={"lm": hparams.get("rescorer_weight", 0.5)},
                           rescorers={"lm": impl})


def dataio_prepare(hparams):
    """Manifests -> datasets of audio and character indices
    (``char_encoded``), the train split sorted by length; the YAML's label
    encoder made from the train split (or loaded from ``save_folder``, as
    ``label_encoder.txt``)."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
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
        ds.add_dynamic_item(
            lambda cl: np.asarray(encoder.encode_sequence_array(cl),
                                  np.int32),
            takes="char_list", provides="char_encoded",
        )
        ds.set_output_keys(["id", "sig", "char_encoded"])
    return datasets


def run(hparams, run_opts, brain_cls=W2VCTC, prepare=prepare_synthetic):
    """The chain after the YAML step: ``prepare(data_folder)`` under
    ``run_opts["debug"]`` where the train manifest is missing, the label
    encoder and datasets, ``fit`` with a shuffled train loader. Returns
    ``(brain, datasets)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare(hparams["data_folder"])
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prepare(hparams)
    if "rescorer_lm" in hparams:
        hparams["rescorer"] = build_rescorer(hparams)
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


def load_run_hparams(argv):
    """``parse_arguments`` and the YAML, with the run's device given to
    the modules it builds, and the experiment directory: ``(hparams,
    run_opts)``. The SSL twins' ``main`` shares it."""
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
    return hparams, run_opts


def main(argv=None):
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
