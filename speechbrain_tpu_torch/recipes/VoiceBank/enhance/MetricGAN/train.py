#!/usr/bin/env python
"""VoiceBank MetricGAN+ on the PyTorch port, the twin of
``recipes/VoiceBank/enhance/MetricGAN/train.py``: a BLSTM masker (the
generator) over the noisy magnitudes ``sqrt(|STFT|^2 + 1e-8)`` and a CNN
discriminator that learns the STOI of (enhanced, clean) magnitude pairs,
anchored by (clean, clean) pairs at 1; the generator drives the predicted
score of its output to 1. The STOI target is measured on the host for
every batch (``nnet/loss/stoi_loss.py``) on the enhanced waveform,
resynthesised with the noisy phase.

Training alternates one discriminator and one generator update a batch
(``Brain.make_gan_steps``), each with its own Adam: the other group's
parameters, optimizer state and BatchNorm statistics stay as they were.
The JAX script runs one Adam over both groups (ROADMAP C50); its
``--debug`` corpus and the YAML's values are this twin's.

``GanBrain`` and ``run``/``main`` serve the other GAN twins (SEGAN,
MetricGAN-U, ``enhancement``, ``dereverb/MetricGAN-U``).

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhance/MetricGAN/hparams/train.yaml \\
        --data_folder=results/metricgan_data --debug --device=cpu
"""

import contextlib
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    forward_with_frozen_buffers,
)
from speechbrain_tpu_torch.nnet.loss.stoi_loss import stoi_loss
from speechbrain_tpu_torch.processing.signal_processing import resynthesize
from speechbrain_tpu_torch.recipes.VoiceBank.enhance import prepare
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)

# the JAX scripts' loader padding: signals to a multiple of 2048 samples
PAD_TO_MULTIPLE = {"noisy_sig": 2048, "clean_sig": 2048}


def step_generator(device, seed, index):
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, index)``:
    the step-indexed draws of the JAX scripts' ``fold_in(key, index)``."""
    state = np.random.SeedSequence([seed, index]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


@contextlib.contextmanager
def evaluating(module):
    """``module`` in evaluation mode for the block, then as it was."""
    was = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was)


class GanBrain(Brain):
    """A Brain of two module groups, ``generator`` and ``discriminator``,
    trained by :meth:`fit_gan`: for each batch :meth:`gan_batch` (with the
    steps of ``make_gan_steps(d_loss_fn, g_loss_fn, "discriminator",
    "generator")`` as ``self.d_step``/``self.g_step``) returns the batch's
    readings; each epoch logs their means and keeps a checkpoint by the
    lowest ``g_loss``."""

    def spec_mag(self, wavs):
        return torch.sqrt(self.hparams.compute_stft.power(wavs) + 1e-8)

    def enhance_mag(self, noisy_mag):
        return noisy_mag * self.modules.generator(noisy_mag)

    @torch.no_grad()
    def enhanced(self, noisy, noisy_mag):
        """The generator's magnitudes (evaluation mode, no graph) and
        their waveform, resynthesised with the noisy phase."""
        with evaluating(self.modules.generator):
            est_mag = self.enhance_mag(noisy_mag)
        return est_mag, resynthesize(est_mag, noisy,
                                     self.hparams.compute_stft,
                                     self.hparams.compute_istft)

    def gan_batch(self, index, batch):
        raise NotImplementedError

    def fit_gan(self, epoch_counter, train_set, loader_kwargs):
        """The alternating updates over ``train_set``, each epoch logged
        and checkpointed; a checkpoint found at the start is recovered,
        both optimizers included."""
        loader = self.make_dataloader(train_set, Stage.TRAIN,
                                      ckpt_prefix=None, **loader_kwargs)
        self.d_step, self.g_step = self.make_gan_steps(
            self.d_loss_fn, self.g_loss_fn, "discriminator", "generator")
        if self.checkpointer is not None:
            self.checkpointer.recover_if_possible()
        opts = self.run_opts
        for epoch in epoch_counter:
            self.modules.train()
            readings = defaultdict(list)
            for i, batch in enumerate(loader):
                if opts.debug and opts.debug_batches and \
                        i >= opts.debug_batches:
                    break
                for key, value in self.gan_batch(
                        i, self._prepare_batch(batch)).items():
                    readings[key].append(value)
            means = {key: float(np.mean(v)) for key, v in readings.items()}
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch}, train_stats=means,
                verbose=False)
            if self.checkpointer is not None:
                self.save_checkpoint(meta={"g_loss": means["g_loss"]},
                                     min_keys=["g_loss"])
            if opts.debug and epoch >= (opts.debug_epochs or 1):
                break


class MetricGanBrain(GanBrain):
    """MetricGAN+: the discriminator regresses the true STOI of
    (enhanced, clean) pairs and 1 for (clean, clean); the generator chases
    a predicted 1."""

    def d_loss_fn(self, batch, generator):
        est_mag, clean_mag, target = batch
        d = self.modules.discriminator
        d_est = d(torch.stack([est_mag, clean_mag], dim=-1))
        d_cln = d(torch.stack([clean_mag, clean_mag], dim=-1))
        return (torch.mean((d_est[:, 0].float() - target) ** 2)
                + torch.mean((d_cln[:, 0].float() - 1.0) ** 2))

    def g_loss_fn(self, batch, generator):
        noisy_mag, clean_mag = batch
        est = self.enhance_mag(noisy_mag)
        d_out = forward_with_frozen_buffers(
            self.modules.discriminator, torch.stack([est, clean_mag], dim=-1))
        return torch.mean((d_out[:, 0].float() - 1.0) ** 2)

    def gan_batch(self, index, batch):
        noisy, lens = batch["noisy_sig"]
        clean = batch["clean_sig"].data
        noisy_mag, clean_mag = self.spec_mag(noisy), self.spec_mag(clean)
        est_mag, est_wav = self.enhanced(noisy, noisy_mag)
        # the discriminator's target: the true STOI of (enhanced, clean)
        sl = stoi_loss(est_wav, clean, lens, reduction="batch")
        target = torch.from_numpy(-np.asarray(sl, np.float32)).to(
            self.device)
        seed = self.run_opts.seed
        d_loss = self.d_step((est_mag, clean_mag, target),
                             step_generator(self.device, seed, 2 * index))
        g_loss = self.g_step((noisy_mag, clean_mag),
                             step_generator(self.device, seed, 2 * index + 1))
        return {"d_loss": float(d_loss), "g_loss": float(g_loss),
                "stoi_loss": float(np.mean(sl))}


def adam_groups(lr):
    """One Adam at ``lr`` for each group (``opt_class`` as a dict)."""
    factory = lambda params: torch.optim.Adam(params, lr=lr)  # noqa: E731
    return {"generator": factory, "discriminator": factory}


def run(hparams, run_opts, brain_cls=MetricGanBrain,
        prepare=spectral_mask.dataio_prepare,
        loader_kwargs=dict(pad_to_multiple=PAD_TO_MULTIPLE), export_from=None):
    """The script after the YAML step: datasets (``prepare``), the Brain
    with one Adam a group at ``lr``, then :meth:`GanBrain.fit_gan` over a
    shuffled train loader (``loader_kwargs`` added). Returns the
    Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = prepare(hparams)
    brain = brain_cls(
        modules=hparams["modules"], opt_class=adam_groups(hparams["lr"]),
        hparams=hparams, run_opts=run_opts,
        checkpointer=hparams["checkpointer"])
    brain.fit_gan(hparams["epoch_counter"], datasets["train"],
                  dict(loader_kwargs, batch_size=hparams["batch_size"],
                       shuffle=True))
    return brain


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``: amplitude-modulated
    tones in white noise."""
    prepare.prepare_synthetic(hparams["data_folder"])


def main(argv=None, run_fn=run, prepare_corpus=prepare_corpus):
    """The spectral-mask twin's ``main``: the YAML loaded beside its file,
    the ``--debug`` corpus where the train manifest is missing, then
    ``run_fn``."""
    return spectral_mask.main(argv, run_fn=run_fn,
                              prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
