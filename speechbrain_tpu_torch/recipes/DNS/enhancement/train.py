#!/usr/bin/env python
"""DNS noise suppression on the PyTorch port, the twin of
``recipes/DNS/enhancement/train.py``: a SepFormer with one source maps
the noisy waveform to the clean one, trained on the negated SI-SNR over
whole signals, Adam, a checkpoint kept by the lowest valid ``si-snr``,
and the best one exported as a ``SepformerSeparation`` source.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.DNS.enhancement.train \\
        speechbrain_tpu_torch/recipes/DNS/enhancement/hparams/sepformer-dns.yaml \\
        --data_folder=results/dns_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.nnet.losses import cal_si_snr
from speechbrain_tpu_torch.recipes.DNS.enhancement.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)


class SISNRBrain(spectral_mask.EnhanceBrain):
    """The time-domain enhancers' bookkeeping: the valid loss logged and
    the best checkpoint kept under ``si-snr``."""

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            return
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch},
            train_stats={"si-snr": self.train_loss},
            valid_stats={"si-snr": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"si-snr": stage_loss},
                             min_keys=["si-snr"])


class Enhance(SISNRBrain):
    """Noisy waveform -> ``modules.model``'s single source; the batch
    mean of the negated SI-SNR against the clean waveform, in float32."""

    def compute_forward(self, batch, stage):
        noisy, _ = batch["noisy_sig"]
        return self.modules.model(noisy)[..., 0]

    def compute_objectives(self, est, batch, stage):
        clean = batch["clean_sig"].data
        return cal_si_snr(clean[..., None], est.float()[..., None]).mean()


def run(hparams, run_opts, brain_cls=Enhance, export_from=None):
    """The spectral-mask twin's ``run`` with this Brain, no padding and
    the ``si-snr`` key, exporting a ``SepformerSeparation`` source."""
    return spectral_mask.run(hparams, run_opts, brain_cls=brain_cls,
                             pad_to_multiple=1, export_from=export_from,
                             export=spectral_mask.export_masknet,
                             min_key="si-snr")


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``."""
    prepare_synthetic(hparams["data_folder"])


def main(argv=None):
    return spectral_mask.main(argv, run_fn=run,
                              prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
