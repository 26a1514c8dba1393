#!/usr/bin/env python
"""LibriSpeech wav2vec 2.0 pretraining on the PyTorch port, the twin of
``recipes/LibriSpeech/self-supervised-learning/wav2vec2/train_sb_wav2vec2.py``.

The waveform goes through the convolutional latent extractor; the Gumbel
quantiser makes the targets from the clean latents; span-masked latents
(the masked frames filled with N(0, 0.1^2) noise) go through the latent
projection, the Transformer context network and the prediction head; the
loss is InfoNCE of the predictions against their targets and 100
negatives from other frames of the same utterance, over the masked
frames, plus the codebook diversity term ``diversity_weight * (GV -
perplexity) / GV``. AdamW (``optax.adamw``'s defaults) at a fixed rate;
batches padded to multiples of 8000 samples; after every valid stage a
line in the train log and a checkpoint kept by the lowest valid loss.

Every draw (the Gumbel noise, the masks, the fill, the negatives) comes
from the Brain's ``generator``, a ``torch.Generator`` on its device seeded
from the run's seed; dropout draws from torch's generator of the device.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing; without ``--device=cpu`` the
modules and the Brain go to the card):

    python -m speechbrain_tpu_torch.recipes.LibriSpeech.self-supervised-learning.wav2vec2.train_sb_wav2vec2 \\
        speechbrain_tpu_torch/recipes/LibriSpeech/self-supervised-learning/wav2vec2/hparams/train_sb_wav2vec2.yaml \\
        --data_folder=results/w2v_data --debug --device=cpu
"""

import sys
from pathlib import Path

import torch

from speechbrain_tpu_torch.core import Brain, Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.lobes.models.wav2vec import (
    fill_masked,
    sample_negatives,
    w2v_contrastive_loss,
    w2v_mask,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train_with_wav2vec import (  # noqa: E501
    load_run_hparams,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    adamw,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare import (
    prepare_synthetic,
)

# waveforms are padded to multiples of 0.5 s (train_sb_wav2vec2.py:163-166)
SIG_PAD_MULTIPLE = 8000


class SBW2V2Pretrain(Brain):
    """Extractor -> quantised targets; masked latents -> projection ->
    context network -> predictions; InfoNCE plus the diversity term."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.generator = torch.Generator(self.device).manual_seed(
            self.run_opts.seed)

    def compute_forward(self, batch, stage):
        wavs, _ = batch["sig"]
        train = stage == Stage.TRAIN
        gen = self.generator
        lat = self.modules.extractor(wavs)
        targets, qinfo = self.modules.quantizer(lat, train=train,
                                                generator=gen)
        mask = w2v_mask(lat.shape[:2], self.hparams.mask_prob,
                        self.hparams.mask_length, gen, lat.device)
        proj = self.modules.latent_proj(fill_masked(lat, mask, gen))
        ctx, _ = self.modules.encoder(proj)
        preds = self.modules.pred_head(ctx)
        negs = sample_negatives(targets, self.hparams.num_negatives, gen)
        return preds, targets, negs, mask, qinfo["prob_perplexity"]

    def compute_objectives(self, predictions, batch, stage):
        preds, targets, negs, mask, perplexity = predictions
        contrastive = w2v_contrastive_loss(
            preds, targets.detach(), negs.detach(), mask,
            temperature=self.hparams.temperature)
        # the gradient reaches the codebook through the soft probabilities
        gv = float(self.hparams.quantiser_vars
                   * self.hparams.quantiser_groups)
        diversity = (gv - perplexity) / gv
        return contrastive + self.hparams.diversity_weight * diversity

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def dataio_prepare(hparams, sort_train=False):
    """Manifests -> datasets of ``id`` and ``sig``; the train split sorted
    by length where ``sort_train``."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]}
        )
        if split == "train" and sort_train:
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.set_output_keys(["id", "sig"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=SBW2V2Pretrain,
        prepare=prepare_synthetic, pad_multiple=SIG_PAD_MULTIPLE,
        sort_train=False):
    """The chain after the YAML step: ``prepare(data_folder)`` under
    ``run_opts["debug"]`` where the train manifest is missing, the
    datasets, ``fit`` with a shuffled train loader. Returns ``(brain,
    datasets)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
        "debug"
    ):
        prepare(hparams["data_folder"])
    datasets = dataio_prepare(hparams, sort_train)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=adamw(hparams["lr"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": pad_multiple}}
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
