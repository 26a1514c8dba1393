#!/usr/bin/env python
"""VoiceBank MetricGAN-U on the PyTorch port, the twin of
``recipes/VoiceBank/enhance/MetricGAN-U/train.py``: unsupervised, no
clean target in the loss. The discriminator learns a non-intrusive score
of the enhanced magnitudes alone, measured on the host on the enhanced
waveform (``target_metric``: ``srmr``, ``tanh(SRMR / srmr_scale)`` by
``processing/srmr.py``; or ``dnsmos``, the callable ``dnsmos_fn``); the
generator drives the predicted score to ``target_score``. STOI against
the clean signal is read for evaluation only.

The official DNSMOS is a web API, which nothing here calls:
``train_dnsmos.yaml``'s ``dnsmos_fn: null`` raises as the JAX script
does; a local scorer runs in its place, e.g.
``--dnsmos_fn='!name:speechbrain_tpu_torch.processing.srmr.srmr_batch'``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN-U.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhance/MetricGAN-U/hparams/train.yaml \\
        --data_folder=results/metricgan_u_data --debug --device=cpu
"""

import sys

import numpy as np
import torch

from speechbrain_tpu_torch.core import forward_with_frozen_buffers
from speechbrain_tpu_torch.nnet.loss.stoi_loss import stoi_loss
from speechbrain_tpu_torch.processing.srmr import srmr_batch
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN import (
    train as metricgan,
)


def target_metric_fn(hparams):
    """The host scorer ``(wavs, lens) -> scores`` that ``target_metric``
    names."""
    target_metric = hparams.get("target_metric", "srmr")
    if target_metric == "srmr":
        scale = hparams["srmr_scale"]
        return lambda wav, lens: np.tanh(srmr_batch(wav, lens) / scale)
    if target_metric == "dnsmos":
        metric_fn = hparams.get("dnsmos_fn")
        if metric_fn is None:
            raise RuntimeError(
                "target_metric=dnsmos needs hparams['dnsmos_fn'] (a "
                "callable scoring enhanced waveforms). The official "
                "DNSMOS is a web service: ask the key from the DNS "
                "organizer dns_challenge@microsoft.com and wrap the "
                "API call, or inject any local non-intrusive scorer.")
        return metric_fn
    raise ValueError(f"unknown target_metric {target_metric!r}")


class MetricGanUBrain(metricgan.GanBrain):
    """The discriminator regresses the host score of one enhanced
    spectrogram; the generator chases ``target_score``."""

    def d_loss_fn(self, batch, generator):
        est_mag, target = batch
        d_est = self.modules.discriminator(est_mag[..., None])
        return torch.mean((d_est[:, 0].float() - target) ** 2)

    def g_loss_fn(self, batch, generator):
        noisy_mag, target_high = batch
        est = self.enhance_mag(noisy_mag)
        d_out = forward_with_frozen_buffers(self.modules.discriminator,
                                            est[..., None])
        return torch.mean((d_out[:, 0].float() - target_high) ** 2)

    def gan_batch(self, index, batch):
        metric_fn = target_metric_fn(vars(self.hparams))
        noisy, lens = batch["noisy_sig"]
        clean = batch["clean_sig"].data
        noisy_mag = self.spec_mag(noisy)
        est_mag, est_wav = self.enhanced(noisy, noisy_mag)
        target = torch.as_tensor(
            np.asarray(metric_fn(est_wav, lens), np.float32),
            device=self.device)
        target_high = float(getattr(self.hparams, "target_score", 1.0))
        seed = self.run_opts.seed
        d_loss = self.d_step((est_mag, target), metricgan.step_generator(
            self.device, seed, 2 * index))
        g_loss = self.g_step((noisy_mag, target_high),
                             metricgan.step_generator(self.device, seed,
                                                      2 * index + 1))
        return {"d_loss": float(d_loss), "g_loss": float(g_loss),
                "stoi_loss": float(stoi_loss(est_wav, clean, lens))}


def run(hparams, run_opts, brain_cls=MetricGanUBrain, export_from=None):
    """The MetricGAN twin's ``run`` with this Brain; the target scorer is
    checked before any step."""
    target_metric_fn(hparams)
    return metricgan.run(hparams, run_opts, brain_cls=brain_cls)


def main(argv=None, prepare_corpus=metricgan.prepare_corpus):
    return metricgan.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
