#!/usr/bin/env python
"""VoiceBank MetricGAN+ with a differentiable target on the PyTorch port,
the twin of ``recipes/VoiceBank/enhancement/train.py``: the discriminator
learns :func:`band_correlation_metric` (the mean per-band correlation of
enhanced and clean magnitude envelopes, an STOI-like score) of
(enhanced, clean) pairs and 1 for (clean, clean); the generator drives
the predicted score of its output to 1. Both steps see the same batch
of noisy and clean magnitudes.

As in the JAX script, the discriminator's running statistics move with
the (enhanced, clean) pairs only: the (clean, clean) anchor and the
generator's step leave them as they were.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhancement.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhancement/hparams/train.yaml \\
        --data_folder=results/enhancement_data --debug --device=cpu
"""

import sys

import torch

from speechbrain_tpu_torch.core import forward_with_frozen_buffers
from speechbrain_tpu_torch.recipes.VoiceBank.enhance import prepare
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN import (
    train as metricgan,
)


def band_correlation_metric(est_mag, clean_mag, lens=None):
    """The mean over frequency of the correlation over time of each
    band's (batch, time, freq) magnitudes, in [-1, 1]: (batch,)."""
    def norm(x):
        x = x - x.mean(dim=1, keepdim=True)
        return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)

    return torch.sum(norm(est_mag) * norm(clean_mag), dim=1).mean(dim=-1)


class MetricGanBrain(metricgan.GanBrain):
    """Alternating updates on one batch of (noisy, clean) magnitudes."""

    def d_loss_fn(self, batch, generator):
        noisy_mag, clean_mag, lens = batch
        with torch.no_grad():
            est = self.enhance_mag(noisy_mag)
        true_metric = band_correlation_metric(est, clean_mag, lens)
        d = self.modules.discriminator
        d_est = d(torch.stack([est, clean_mag], dim=-1))
        d_clean = forward_with_frozen_buffers(
            d, torch.stack([clean_mag, clean_mag], dim=-1))
        return (torch.mean((d_est[:, 0].float() - true_metric) ** 2)
                + torch.mean((d_clean[:, 0].float() - 1.0) ** 2))

    def g_loss_fn(self, batch, generator):
        noisy_mag, clean_mag, lens = batch
        est = self.enhance_mag(noisy_mag)
        d_out = forward_with_frozen_buffers(
            self.modules.discriminator, torch.stack([est, clean_mag], dim=-1))
        return torch.mean((d_out[:, 0].float() - 1.0) ** 2)

    def gan_batch(self, index, batch):
        noisy, lens = batch["noisy_sig"]
        b = (self.spec_mag(noisy), self.spec_mag(batch["clean_sig"].data),
             lens)
        seed = self.run_opts.seed
        d_loss = self.d_step(b, metricgan.step_generator(self.device, seed,
                                                         2 * index))
        g_loss = self.g_step(b, metricgan.step_generator(self.device, seed,
                                                         2 * index + 1))
        return {"d_loss": float(d_loss), "g_loss": float(g_loss)}


def run(hparams, run_opts, brain_cls=MetricGanBrain, export_from=None):
    """The MetricGAN twin's ``run`` with this Brain."""
    return metricgan.run(hparams, run_opts, brain_cls=brain_cls)


def prepare_corpus(hparams):
    """The ``--debug`` corpus: unmodulated tones in white noise."""
    prepare.prepare_synthetic(hparams["data_folder"], modulated=False)


def main(argv=None):
    return metricgan.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
