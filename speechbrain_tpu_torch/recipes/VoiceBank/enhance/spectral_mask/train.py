#!/usr/bin/env python
"""VoiceBank spectral-mask enhancement on the PyTorch port, the twin of
``recipes/VoiceBank/enhance/spectral_mask/train.py``: a masking model
(the YAML's ``MaskNet``: CNN-Transformer, BLSTM, 2-D FCN or FCN+BLSTM)
over the noisy magnitudes ``sqrt(|STFT|^2 + 1e-8)``, the masked
magnitudes against the clean ones by ``mse_loss`` over the lengths, Adam,
a checkpoint kept by the lowest valid loss, and the best one exported as
a ``SpectralMaskEnhancement`` source (``<output_folder>/pretrained``).

The interface masks ``log1p`` magnitudes where this recipe trains on
plain ones, as in the JAX package: an exported model is served on other
features than it was trained on (a policy kept, not repaired).

``run`` and ``main`` serve the other enhancement twins (waveform_map,
dereverb, DNS, WHAM!/WHAMR!, the template), which differ in their Brain,
corpus, padding and export.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/enhance/spectral_mask/hparams/train.yaml \\
        --data_folder=results/voicebank_data --debug --device=cpu
"""

import os
import sys
from pathlib import Path

import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import mse_loss
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.pretrained import (
    export_enhancer,
    export_separator,
)

# the JAX recipe's loader padding: signals to a multiple of 2048 samples
PAD_TO_MULTIPLE = {"noisy_sig": 2048, "clean_sig": 2048}


class EnhanceBrain(Brain):
    """Noisy magnitudes -> ``modules.model``'s mask -> masked magnitudes;
    the length-masked MSE against the clean magnitudes, in float32. The
    best checkpoint is kept by ``loss``."""

    def spec_mag(self, wavs):
        return torch.sqrt(self.hparams.compute_stft.power(wavs) + 1e-8)

    def compute_forward(self, batch, stage):
        noisy, lens = batch["noisy_sig"]
        noisy_mag = self.spec_mag(noisy)
        return noisy_mag * self.modules.model(noisy_mag), lens

    def compute_objectives(self, predictions, batch, stage):
        est_mag, lens = predictions
        clean = batch["clean_sig"].data
        return mse_loss(est_mag.float(), self.spec_mag(clean), length=lens)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.TRAIN:
            return
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def dataio_prepare(hparams, signals=("noisy", "clean")):
    """Train and valid datasets of each ``<name>_wav``'s whole signal as
    ``<name>_sig``."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        for name in signals:
            ds.add_dynamic_item(read_audio, takes=f"{name}_wav",
                                provides=f"{name}_sig")
        ds.set_output_keys(["id"] + [f"{name}_sig" for name in signals])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=EnhanceBrain, prepare=dataio_prepare,
        pad_to_multiple=PAD_TO_MULTIPLE, export_from=None,
        export=export_enhancer, min_key="loss"):
    """The script after the YAML step: datasets (``prepare``), then
    ``fit`` with Adam at ``lr``, a shuffled train loader and both loaders
    padding to ``pad_to_multiple``; where ``export_from`` gives the run's
    ``(yaml text, overrides, yaml folder)``, the best checkpoint by
    ``min_key`` goes through ``export`` (``export_enhancer``, or
    :func:`export_masknet` for a time-domain separation model) to
    ``<output_folder>/pretrained``. Returns the Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = prepare(hparams)
    lr = hparams["lr"]
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=lambda params: torch.optim.Adam(params, lr=lr),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": pad_to_multiple}
    brain.fit(hparams["epoch_counter"], datasets["train"], datasets["valid"],
              train_loader_kwargs=dict(loader, shuffle=True),
              valid_loader_kwargs=loader)
    if export_from is not None:
        text, overrides, yaml_dir = export_from
        export(hparams, text, overrides,
               folder=Path(hparams["output_folder"]) / "pretrained",
               yaml_dir=yaml_dir, min_key=min_key)
    return brain


def export_masknet(hparams, yaml_text, overrides, folder, yaml_dir,
                   min_key):
    """``export_separator`` with ``export_enhancer``'s arguments: a
    time-domain model (a separation wrapper with one source) as a
    ``SepformerSeparation`` source."""
    return export_separator(hparams, yaml_text, overrides, folder=folder,
                            min_key=min_key)


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``."""
    prepare_synthetic(hparams["data_folder"])


def load_twin_yaml(hparams_file, overrides):
    """A twin YAML's text and the objects it builds with ``overrides``,
    its ``!include:`` paths read beside the file: ``(text, hparams)``."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    text = Path(hparams_file).read_text(encoding="utf-8")
    return text, load_hyperpyyaml(text, overrides,
                                  base_dir=os.path.dirname(hparams_file))


def main(argv=None, run_fn=run, prepare_corpus=prepare_corpus):
    """Parse the command line, load the YAML (``--device`` goes to every
    object it builds), make a synthetic corpus under ``--debug`` where the
    train manifest is missing (``prepare_corpus(hparams)``), then
    ``run_fn``, which exports the best checkpoint."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    if "device" in run_opts:
        overrides["device"] = run_opts["device"]
    text, hparams = load_twin_yaml(hparams_file, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file,
        overrides=overrides,
    )
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
            "debug"):
        prepare_corpus(hparams)
    return run_fn(hparams, run_opts, export_from=(
        text, overrides, os.path.dirname(hparams_file)))


if __name__ == "__main__":
    main(sys.argv[1:])
