#!/usr/bin/env python
"""Speech-enhancement training template on the PyTorch port, the twin of
``templates/enhancement/train.py``: noisy magnitudes ``sqrt(|STFT|^2 +
1e-8)`` -> a causal ``CNNTransformerSE`` mask -> masked magnitudes
against the clean ones by ``mse_loss`` over the lengths, Adam, both
loaders padding to a multiple of 2048 samples, a checkpoint kept by the
lowest valid loss, exported as a ``SpectralMaskEnhancement`` source.

Expects JSON manifests ``{utt: {"noisy_wav": path, "clean_wav": path,
"length": s}}``; under ``--debug`` a missing manifest is made from the
VoiceBank twins' synthetic corpus (the JAX template makes none). Run from
the repository's root:

    python -m speechbrain_tpu_torch.templates.enhancement.train \\
        speechbrain_tpu_torch/templates/enhancement/train.yaml \\
        --data_folder=results/enhancement_data --debug --device=cpu
"""

import sys

from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)

EnhanceBrain = spectral_mask.EnhanceBrain


def run(hparams, run_opts, brain_cls=EnhanceBrain, export_from=None):
    """The spectral-mask twin's ``run`` padding every signal to a multiple
    of 2048 samples."""
    return spectral_mask.run(hparams, run_opts, brain_cls=brain_cls,
                             pad_to_multiple=2048, export_from=export_from)


def main(argv=None):
    return spectral_mask.main(argv, run_fn=run)


if __name__ == "__main__":
    main(sys.argv[1:])
