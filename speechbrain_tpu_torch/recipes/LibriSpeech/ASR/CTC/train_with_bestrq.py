#!/usr/bin/env python
"""LibriSpeech character CTC fine-tuning a BEST-RQ pretrained Conformer on
the PyTorch port, the twin of ``recipes/LibriSpeech/ASR/CTC/train_with_bestrq.py``.

Fbank (fused: kernel B3 on every batch) -> sentence normalisation ->
convolutional front end -> encoder-only ``TransformerASR`` -> CTC head; the
CTC loss over characters (``CTCTextEncoder``, blank ``<blank>``). AdamW
(``optax.adamw``'s defaults) in two param groups: ``"encoder"`` (the front
end and the encoder) at ``lr_encoder`` and ``"main"`` (the head) at ``lr``,
each annealed by its own NewBob scheduler after every valid stage, which
logs and keeps a checkpoint by the lowest valid loss.
``BestRQCTC.transcribe_batch`` decodes a batch greedily.

With ``pretrained_folder`` set, :func:`pour_pretrained` collects the BEST-RQ
pretraining's ``frontend.ckpt`` and ``encoder.ckpt`` and loads them into
the modules before ``fit``. The JAX script collects the files and never
loads them, so its fine-tuning starts from a fresh init (ROADMAP C53). The
pretraining's encoder has regular attention where this one has
``RelPosMHAXL`` (C54): every pretrained tensor loads, and the
relative-position projections (``pos_proj``, ``pos_bias_u``,
``pos_bias_v`` of each layer) keep their init.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_bestrq \\
        speechbrain_tpu_torch/recipes/LibriSpeech/ASR/CTC/hparams/train_with_bestrq.yaml \\
        --data_folder=results/ctc_data --debug --device=cpu \\
        --pretrained_folder=<a BEST-RQ run's save folder>
"""

import re
import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import Brain, Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.dataio.encoder import CTCTextEncoder
from speechbrain_tpu_torch.decoders.ctc import ctc_greedy_decode
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.parameter_transfer import Pretrainer

ENCODER_MODULES = ("frontend", "encoder")
# waveforms are padded to multiples of 1 s (train_with_bestrq.py:203-206)
SIG_PAD_MULTIPLE = 16000
# the parameters a RelPosMHAXL encoder has and a regular-attention one lacks
RELPOS_ONLY = re.compile(r"\.attn\.(pos_proj\.weight|pos_bias_[uv])$")


class BestRQCTC(Brain):
    """Pretrained Fbank -> front end -> Conformer encoder + linear CTC
    head."""

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        feats = self.modules.frontend(feats)
        enc = self.modules.encoder.encode(feats, wav_len=wav_lens)
        logits = self.modules.ctc_head(enc)
        return torch.log_softmax(logits.float(), -1)

    def compute_objectives(self, p_ctc, batch, stage):
        _, wav_lens = batch["sig"]
        tokens, tok_lens = batch["tokens"]
        return ctc_loss(p_ctc, tokens, wav_lens, tok_lens,
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

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        old_lr, new_lr = self.hparams.lr_annealing(stage_loss)
        old_lr_e, new_lr_e = self.hparams.lr_annealing_encoder(stage_loss)
        update_learning_rate(self.optimizer, new_lr, group="main")
        update_learning_rate(self.optimizer, new_lr_e, group="encoder")
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch, "lr": old_lr,
                        "lr_encoder": old_lr_e},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def make_optimizer(hparams):
    """``params -> AdamW`` with the groups ``"encoder"`` (the modules of
    ``ENCODER_MODULES``, at ``lr_encoder``) and ``"main"`` (the rest, at
    ``lr``); ``optax.adamw``'s defaults."""

    def factory(params):
        encoder = [p for name in ENCODER_MODULES
                   for p in hparams["modules"][name].parameters()]
        taken = {id(p) for p in encoder}
        main = [p for p in params if id(p) not in taken]
        return torch.optim.AdamW(
            [{"params": encoder, "lr": hparams["lr_encoder"],
              "name": "encoder"},
             {"params": main, "lr": hparams["lr"], "name": "main"}],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

    return factory


def dataio_prepare(hparams):
    """Manifests -> datasets of audio and character indices (``tokens``);
    the character encoder made from the train split (or loaded from
    ``save_folder``, as ``label_encoder.txt``) and ``hparams["blank_index"]``
    set to its blank, ``<blank>``."""
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
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="char_list",
        sequence_input=True,
        special_labels={"blank_label": "<blank>"},
    )
    hparams["blank_index"] = encoder.get_blank_index()
    for ds in datasets.values():
        ds.add_dynamic_item(
            lambda cl: np.asarray(encoder.encode_sequence_array(cl),
                                  np.int32),
            takes="char_list", provides="tokens",
        )
        ds.set_output_keys(["id", "sig", "tokens"])
    return datasets


def pour_pretrained(hparams):
    """Collect ``<pretrained_folder>/{frontend,encoder}.ckpt`` into
    ``save_folder`` and load them into the modules of ``ENCODER_MODULES``.
    Every tensor of a file must load; a parameter the file lacks may only
    be a relative-position one (``RELPOS_ONLY``), which keeps its init.
    Returns the names of the parameters left at their init."""
    folder = hparams["pretrained_folder"]
    pretrainer = Pretrainer(
        collect_in=hparams["save_folder"],
        loadables={name: hparams[name] for name in ENCODER_MODULES},
        paths={name: f"{folder}/{name}.ckpt" for name in ENCODER_MODULES},
    )
    fresh = []
    for name, path in pretrainer.collect_files().items():
        module = hparams[name]
        state = torch.load(path, map_location=next(module.parameters()).device,
                           weights_only=True)
        missing, unexpected = module.load_state_dict(state, strict=False)
        strays = [k for k in missing if not RELPOS_ONLY.search(k)]
        if unexpected or strays:
            raise RuntimeError(
                f"{path} does not fit {name}: unexpected {unexpected}, "
                f"missing {strays}")
        fresh += [f"{name}.{k}" for k in missing]
    return fresh


def run(hparams, run_opts, brain_cls=BestRQCTC):
    """The chain after the YAML step: a synthetic corpus under
    ``run_opts["debug"]`` where the train manifest is missing, the
    character encoder and datasets, the pretrained weights where
    ``pretrained_folder`` is set, ``fit`` with a shuffled train loader.
    Returns ``(brain, datasets)``."""
    if run_opts.get("debug") and not Path(
        hparams["train_annotation"]
    ).exists():
        prepare_synthetic(hparams["data_folder"])
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prepare(hparams)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=make_optimizer(hparams),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    if hparams.get("pretrained_folder"):
        pour_pretrained(hparams)
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
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
