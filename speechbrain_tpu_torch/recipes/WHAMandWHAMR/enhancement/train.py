#!/usr/bin/env python
"""WHAM!/WHAMR! speech enhancement on the PyTorch port, the twin of
``recipes/WHAMandWHAMR/enhancement/train.py``: the separation models with
one source, on the WHAM!/WHAMR! separation twin's corpus, against its
first source.

* time domain (SepFormer, Conv-TasNet, DPRNN): mixture -> model -> the
  clean waveform, trained on the negated SI-SNR; the best checkpoint is
  exported as a ``SepformerSeparation`` source;
* frequency domain (``use_freq_domain``, the CNN-Transformer YAMLs):
  ``log1p`` magnitudes of ``compute_stft`` -> mask -> the masked features
  against the clean ones' by the mean squared error; the best checkpoint
  is exported as a ``SpectralMaskEnhancement`` source, whose features are
  these.

With ``dynamic_mixing`` each training mixture is remixed as ``clean +
g (mix - clean)``, ``g`` uniform in [0.5, 1.5) a mixture, drawn from a
``torch.Generator`` seeded with the YAML's ``seed``. The best checkpoint
is kept by ``si-snr`` (the valid loss, whichever it is), as the JAX
script keeps it.

Run from the repository's root (a synthetic noisy, reverberant where the
YAML says ``use_reverb``, corpus is made under ``--debug`` where the
manifest is missing):

    python -m speechbrain_tpu_torch.recipes.WHAMandWHAMR.enhancement.train \\
        speechbrain_tpu_torch/recipes/WHAMandWHAMR/enhancement/hparams/sepformer-wham.yaml \\
        --data_folder=results/wham_enh_data --debug --device=cpu
"""

import sys

import torch

from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.nnet.losses import cal_si_snr
from speechbrain_tpu_torch.processing.features import spectral_magnitude
from speechbrain_tpu_torch.recipes.DNS.enhancement.train import SISNRBrain
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)
from speechbrain_tpu_torch.recipes.WHAMandWHAMR.separation.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.pretrained import export_enhancer


class Enhancement(SISNRBrain):
    """Mask-based single-source enhancement, by SI-SNR in the time domain
    or by spectral MSE in the frequency domain."""

    def _freq(self):
        return getattr(self.hparams, "use_freq_domain", False)

    def _feats(self, wavs):
        spec = self.hparams.compute_stft(wavs)
        return torch.log1p(spectral_magnitude(spec, power=0.5))

    def mixing_generator(self):
        """The dynamic-mixing gains' generator (on the CPU), seeded with
        the YAML's ``seed`` at its first use."""
        if getattr(self, "_mixing_generator", None) is None:
            self._mixing_generator = torch.Generator().manual_seed(
                int(self.hparams.seed))
        return self._mixing_generator

    def compute_forward(self, batch, stage):
        mix, _ = batch["mix_sig"]
        if stage == Stage.TRAIN and getattr(self.hparams, "dynamic_mixing",
                                            False):
            clean = batch["s1_sig"].data
            gain = 0.5 + torch.rand((mix.shape[0], 1),
                                    generator=self.mixing_generator())
            mix = clean + gain.to(mix.device) * (mix - clean)
        if self._freq():
            feats = self._feats(mix)
            return feats * self.modules.model(feats)
        return self.modules.model(mix)

    def compute_objectives(self, est, batch, stage):
        clean = batch["s1_sig"].data
        if self._freq():
            return ((est.float() - self._feats(clean)) ** 2).mean()
        return cal_si_snr(clean[..., None], est.float()).mean()


def run(hparams, run_opts, brain_cls=Enhancement, export_from=None):
    """The spectral-mask twin's ``run`` over the mixtures and first
    sources, no padding, the ``si-snr`` key, and the export that serves
    the YAML's domain."""
    freq = hparams.get("use_freq_domain", False)
    return spectral_mask.run(
        hparams, run_opts, brain_cls=brain_cls,
        prepare=lambda h: spectral_mask.dataio_prepare(h, ("mix", "s1")),
        pad_to_multiple=1, export_from=export_from,
        export=export_enhancer if freq else spectral_mask.export_masknet,
        min_key="si-snr")


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``: the separation twin's
    mixtures (at 8 kHz), reverberant where the YAML says ``use_reverb``."""
    prepare_synthetic(hparams["data_folder"],
                      reverb=hparams.get("use_reverb", False))


def main(argv=None):
    return spectral_mask.main(argv, run_fn=run,
                              prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
