#!/usr/bin/env python
"""LibriSpeech BEST-RQ pretraining on the PyTorch port, the twin of
``recipes/LibriSpeech/self-supervised-learning/BEST-RQ/train.py``.

Fbank (fused: kernel B3 on every batch) -> sentence normalisation; span
masks over the frames; the frozen random-projection quantiser gives each
clean frame its codeword id; the masked frames are filled with N(0, 0.1^2)
noise and go through the convolutional front end and the Conformer
encoder (``TransformerASR.encode``) to a linear head over the codebook;
the loss is the cross-entropy of the codeword ids at the masked frames,
taken at the front end's rate (every ``stride``-th frame). AdamW
(``optax.adamw``'s defaults) over every parameter: the quantiser has none
(its ``P`` and ``CB`` are buffers), where JAX zeroes its updates with
``optax.set_to_zero``. NewBob anneals the rate after every valid stage,
which logs and keeps a checkpoint by the lowest valid loss.

After ``fit``, :func:`export_encoder` writes the best checkpoint's front
end and encoder to ``<save_folder>/frontend.ckpt`` and ``encoder.ckpt``,
where ``train_with_bestrq.py`` reads them from its ``pretrained_folder``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.self-supervised-learning.BEST-RQ.train \\
        speechbrain_tpu_torch/recipes/LibriSpeech/self-supervised-learning/BEST-RQ/hparams/bestrq.yaml \\
        --data_folder=results/brq_data --debug --device=cpu
"""

import sys
from pathlib import Path

import torch

from speechbrain_tpu_torch.core import Brain, Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.lobes.models.BESTRQ import (
    brq_accuracy,
    compute_brq_loss,
)
from speechbrain_tpu_torch.lobes.models.wav2vec import fill_masked, w2v_mask
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    adamw,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)

# waveforms are padded to multiples of 1 s (train.py:175-178)
SIG_PAD_MULTIPLE = 16000
# the modules the pretraining hands to the CTC fine-tuning
EXPORTED = ("frontend", "encoder")


class BestRQ(Brain):
    """Masked Fbank -> front end -> Conformer -> codeword logits."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.generator = torch.Generator(self.device).manual_seed(
            self.run_opts.seed)

    def compute_forward(self, batch, stage):
        wavs, wav_lens = batch["sig"]
        gen = self.generator
        feats = self.hparams.compute_features(wavs)
        feats = self.hparams.normalize(feats, wav_lens)
        mask = w2v_mask(feats.shape[:2], self.hparams.mask_prob,
                        self.hparams.mask_length, gen, feats.device)
        # targets from the clean frames
        targets = self.modules.quantizer(feats)
        x = self.modules.frontend(fill_masked(feats, mask, gen))
        # the front end's strides: the mask and targets at its rate
        stride = feats.shape[1] // x.shape[1] if x.shape[1] else 1
        sub_mask = mask[:, ::stride][:, :x.shape[1]]
        sub_targets = targets[:, ::stride][:, :x.shape[1]]
        enc = self.modules.encoder.encode(x, wav_len=wav_lens)
        return self.modules.head(enc), sub_targets, sub_mask

    def compute_objectives(self, predictions, batch, stage):
        logits, targets, mask = predictions
        loss = compute_brq_loss(logits, targets, mask)
        return loss, {"acc": brq_accuracy(logits, targets, mask)}

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


def dataio_prepare(hparams):
    """Manifests -> datasets of ``id`` and ``sig``, the train split sorted
    by length."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.set_output_keys(["id", "sig"])
        datasets[split] = ds
    return datasets


def export_encoder(hparams):
    """Recover the checkpoint of lowest valid loss into the modules and
    write each of ``EXPORTED`` as ``<save_folder>/<name>.ckpt`` (a state
    dict). Returns the paths by name."""
    if hparams["checkpointer"].recover_if_possible(min_key="loss") is None:
        raise RuntimeError("no checkpoint to export")
    paths = {}
    for name in EXPORTED:
        paths[name] = Path(hparams["save_folder"]) / f"{name}.ckpt"
        torch.save(hparams[name].state_dict(), paths[name])
    return paths


def run(hparams, run_opts, brain_cls=BestRQ, prepare=prepare_synthetic):
    """The chain after the YAML step: ``prepare(data_folder)`` under
    ``run_opts["debug"]`` where the train manifest is missing, the
    datasets, ``fit`` with a shuffled train loader, then
    :func:`export_encoder`. Returns ``(brain, datasets)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare(hparams["data_folder"])
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
    export_encoder(hparams)
    return brain, datasets


def main(argv=None):
    return run(*load_run_hparams(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
