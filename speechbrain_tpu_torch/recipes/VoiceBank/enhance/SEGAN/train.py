#!/usr/bin/env python
"""VoiceBank SEGAN on the PyTorch port, the twin of
``recipes/VoiceBank/enhance/SEGAN/train.py``: a waveform GAN. The
generator autoencodes noisy segments of ``segment_size`` samples with skip
connections and a latent ``z``; the discriminator judges (noisy, clean)
against (noisy, enhanced) pairs by least squares, and the generator adds
an L1 waveform term (``l1_weight``).

Each batch takes one discriminator and one generator update, each with
its own Adam (``Brain.make_gan_steps``); the latent ``z`` of step ``i``
comes from a generator seeded from ``(seed, 2 i)`` (the discriminator's)
and ``(seed, 2 i + 1)`` (the generator's), as the JAX script folds the
step's index into its key. Segments are cut at random offsets drawn from
a numpy generator seeded with ``seed``, as in the JAX script.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhance.SEGAN.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhance/SEGAN/hparams/train.yaml \\
        --data_folder=results/segan_data --debug --device=cpu
"""

import sys

import numpy as np
import torch

from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.recipes.VoiceBank.enhance import prepare
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN import (
    train as metricgan,
)


class SeganBrain(metricgan.GanBrain):
    """Least-squares GAN on (noisy, clean or enhanced) waveform pairs."""

    def d_loss_fn(self, batch, generator):
        noisy, clean = batch
        with torch.no_grad():
            fake = self.modules.generator(noisy, generator=generator)
        d = self.modules.discriminator
        d_real = d(torch.stack([noisy, clean], dim=-1)).float()
        d_fake = d(torch.stack([noisy, fake], dim=-1)).float()
        return torch.mean((d_real - 1.0) ** 2) + torch.mean(d_fake ** 2)

    def g_loss_fn(self, batch, generator):
        noisy, clean = batch
        fake = self.modules.generator(noisy, generator=generator)
        d_fake = self.modules.discriminator(
            torch.stack([noisy, fake], dim=-1)).float()
        adv = torch.mean((d_fake - 1.0) ** 2)
        l1 = torch.mean(torch.abs(fake.float() - clean))
        return adv + self.hparams.l1_weight * l1

    def gan_batch(self, index, batch):
        pair = (batch["noisy_sig"].data, batch["clean_sig"].data)
        seed = self.run_opts.seed
        d_loss = self.d_step(pair, metricgan.step_generator(
            self.device, seed, 2 * index))
        g_loss = self.g_step(pair, metricgan.step_generator(
            self.device, seed, 2 * index + 1))
        return {"d_loss": float(d_loss), "g_loss": float(g_loss)}


def dataio_prepare(hparams):
    """Train and valid datasets of (noisy, clean) segments of
    ``segment_size`` samples at one random offset per read (zero-padded
    where the pair is shorter)."""
    seg = hparams["segment_size"]
    rng = np.random.default_rng(hparams["seed"])
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})

        def pair_pipeline(noisy_wav, clean_wav):
            n = np.asarray(read_audio(noisy_wav))
            c = np.asarray(read_audio(clean_wav))
            L = min(len(n), len(c))
            if L < seg:
                n = np.pad(n[:L], (0, seg - L))
                c = np.pad(c[:L], (0, seg - L))
                start = 0
            else:
                start = int(rng.integers(0, L - seg + 1))
            yield n[start:start + seg]
            yield c[start:start + seg]

        ds.add_dynamic_item(pair_pipeline, takes=["noisy_wav", "clean_wav"],
                            provides=["noisy_sig", "clean_sig"])
        ds.set_output_keys(["id", "noisy_sig", "clean_sig"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=SeganBrain, export_from=None):
    """The MetricGAN twin's ``run`` with this Brain and corpus, unpadded
    (the segments are of one length)."""
    return metricgan.run(hparams, run_opts, brain_cls=brain_cls,
                         prepare=dataio_prepare, loader_kwargs={})


def prepare_corpus(hparams):
    """The ``--debug`` corpus: unmodulated tones in white noise."""
    prepare.prepare_synthetic(hparams["data_folder"], modulated=False)


def main(argv=None):
    return metricgan.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
