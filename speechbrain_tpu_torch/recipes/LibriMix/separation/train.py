#!/usr/bin/env python
"""LibriMix source separation on the PyTorch port, the twin of
``recipes/LibriMix/separation/train.py``: mixture -> a separation model
(``SepformerWrapper`` in both YAMLs) -> one estimate a speaker, the
negated permutation-invariant SI-SNR over the ``num_spks`` sources (over
whole signals, as the JAX script reads no lengths), Adam, a checkpoint
kept by the lowest valid loss (``si-snr`` in its meta).

``Separation``, ``run`` and ``main`` serve the WHAM!/WHAMR! and
Aishell1Mix twins too, which differ in their corpora.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriMix.separation.train \\
        speechbrain_tpu_torch/recipes/LibriMix/separation/hparams/sepformer-libri2mix.yaml \\
        --data_folder=results/librimix_data --debug --device=cpu
"""

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
from speechbrain_tpu_torch.nnet.losses import get_si_snr_with_pitwrapper
from speechbrain_tpu_torch.recipes.LibriMix.separation.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.pretrained import export_separator


class Separation(Brain):
    """Mixture -> ``modules.model`` -> (B, T, num_spks); the mean over the
    batch of the negated PIT SI-SNR, in float32."""

    def compute_forward(self, batch, stage):
        mix, _ = batch["mix_sig"]
        return self.modules.model(mix)

    def sources(self, batch):
        """The targets (B, T, num_spks)."""
        return torch.stack([batch[f"s{i + 1}_sig"].data
                            for i in range(self.hparams.num_spks)], dim=-1)

    def compute_objectives(self, est, batch, stage):
        return get_si_snr_with_pitwrapper(self.sources(batch),
                                          est.float()).mean()

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


def dataio_prepare(hparams):
    """Train and valid datasets of the mixture and each source's whole
    signal (``mix_sig``, ``s<i>_sig``)."""
    datasets = {}
    spk_keys = [f"s{i + 1}_sig" for i in range(hparams["num_spks"])]
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="mix_wav", provides="mix_sig")
        for i in range(hparams["num_spks"]):
            ds.add_dynamic_item(read_audio, takes=f"s{i + 1}_wav",
                                provides=f"s{i + 1}_sig")
        ds.set_output_keys(["id", "mix_sig"] + spk_keys)
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=Separation, prepare=dataio_prepare,
        export_from=None, min_key="si-snr"):
    """The script after the YAML step: datasets (``prepare``), then
    ``fit`` with Adam at ``lr`` and a shuffled train loader; where
    ``export_from`` gives the run's ``(yaml text, overrides)``, the best
    checkpoint by ``min_key`` is exported to ``<output_folder>/pretrained``
    for ``SepformerSeparation.from_hparams``. Returns the Brain."""
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
    brain.fit(
        hparams["epoch_counter"],
        datasets["train"],
        datasets["valid"],
        train_loader_kwargs={"batch_size": hparams["batch_size"],
                             "shuffle": True},
        valid_loader_kwargs={"batch_size": hparams["batch_size"]},
    )
    if export_from is not None:
        export_separator(hparams, *export_from, min_key=min_key,
                         folder=Path(hparams["output_folder"]) / "pretrained")
    return brain


def prepare_corpus(hparams):
    """The ``--debug`` corpus: ``prepare_synthetic`` into
    ``data_folder`` with the YAML's number of speakers."""
    prepare_synthetic(hparams["data_folder"], num_spks=hparams["num_spks"])


def main(argv=None, run_fn=run, prepare_corpus=prepare_corpus):
    """Parse the command line, load the YAML (``--device`` goes to every
    module it builds), make a synthetic corpus under ``--debug`` where the
    train manifest is missing (``prepare_corpus(hparams)``), then
    ``run_fn``."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    if "device" in run_opts:
        overrides["device"] = run_opts["device"]
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    text = Path(hparams_file).read_text(encoding="utf-8")
    hparams = load_hyperpyyaml(text, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file,
        overrides=overrides,
    )
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
            "debug"):
        prepare_corpus(hparams)
    return run_fn(hparams, run_opts, export_from=(text, overrides))


if __name__ == "__main__":
    main(sys.argv[1:])
