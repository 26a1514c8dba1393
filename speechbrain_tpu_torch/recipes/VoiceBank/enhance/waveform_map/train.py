#!/usr/bin/env python
"""VoiceBank waveform-mapping enhancement on the PyTorch port, the twin of
``recipes/VoiceBank/enhance/waveform_map/train.py``: a fully-convolutional
mapper (``WaveFCNMapper``) from noisy to clean waveforms under ``l1_loss``
over the lengths, Adam, a checkpoint kept by the lowest valid loss, and
the best one exported as a ``WaveformEnhancement`` source. The loaders pad
the signals to a multiple of 16384 samples, as the JAX script's do.

Run from the repository's root (the VoiceBank twins' synthetic corpus is
made under ``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhance.waveform_map.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhance/waveform_map/hparams/train.yaml \\
        --data_folder=results/voicebank_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.nnet.losses import l1_loss
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)

PAD_TO_MULTIPLE = {"noisy_sig": 16384, "clean_sig": 16384}


class WaveMapBrain(spectral_mask.EnhanceBrain):
    """Noisy waveforms -> ``modules.model`` -> estimates; the
    length-masked L1 distance to the clean waveforms, in float32."""

    def compute_forward(self, batch, stage):
        noisy, lens = batch["noisy_sig"]
        return self.modules.model(noisy), lens

    def compute_objectives(self, predictions, batch, stage):
        est, lens = predictions
        return l1_loss(est.float(), batch["clean_sig"].data, length=lens)


def run(hparams, run_opts, brain_cls=WaveMapBrain, export_from=None):
    """The spectral-mask twin's ``run`` with this Brain and padding."""
    return spectral_mask.run(hparams, run_opts, brain_cls=brain_cls,
                             pad_to_multiple=PAD_TO_MULTIPLE,
                             export_from=export_from)


def main(argv=None):
    return spectral_mask.main(argv, run_fn=run)


if __name__ == "__main__":
    main(sys.argv[1:])
