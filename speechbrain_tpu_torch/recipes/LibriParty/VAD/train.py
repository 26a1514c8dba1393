#!/usr/bin/env python
"""LibriParty voice activity detection on the PyTorch port, the twin of
``recipes/LibriParty/VAD/train.py``: Fbank -> CRDNN -> ``out_lin``, one
speech logit a frame, binary cross-entropy against frame labels taken
from the speech intervals (a frame is speech where its centre lies in an
interval), Adam, a checkpoint kept by the lowest valid loss.

With the run's YAML (``main``), the best checkpoint is exported to
``pretrained_folder`` for ``VAD.from_hparams``
(``utils/pretrained.export_frame_model``: the CRDNN and ``out_lin`` served
in sequence as ``model``, behind the fused Fbank).

Run from the repository's root (a synthetic party set is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.LibriParty.VAD.train \\
        speechbrain_tpu_torch/recipes/LibriParty/VAD/hparams/train.yaml \\
        --data_folder=results/vad_data --debug --device=cpu
"""

import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import (
    Brain,
    Stage,
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import bce_loss
from speechbrain_tpu_torch.recipes.LibriParty.VAD.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.pretrained import export_frame_model


def frames_inside(n_frames, duration, intervals):
    """(B, n_frames, n_intervals) booleans: whether the centre of each of
    ``n_frames`` frames spread evenly over ``duration`` seconds lies in
    each ``[start, end)`` of ``intervals`` (B, n_intervals, >= 2)."""
    centers = (torch.arange(n_frames, device=intervals.device) + 0.5) * (
        duration / n_frames)
    starts, ends = intervals[..., 0], intervals[..., 1]
    return ((centers[None, :, None] >= starts[:, None, :])
            & (centers[None, :, None] < ends[:, None, :]))


class FrameBrain(Brain):
    """Fbank -> ``model`` -> ``out_lin``: (B, frames, classes) logits;
    the valid stage logs and keeps the best checkpoint."""

    def compute_forward(self, batch, stage):
        wavs, _ = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        return self.modules.out_lin(self.modules.model(feats)).float()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.VALID:
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


class VADBrain(FrameBrain):
    """One speech logit a frame, binary cross-entropy."""

    def compute_objectives(self, logits, batch, stage):
        wavs, _ = batch["sig"]
        intervals, _ = batch["speech_intervals"]
        logits = logits[..., 0]
        inside = frames_inside(logits.shape[1],
                               wavs.shape[1] / self.hparams.sample_rate,
                               intervals.to(logits.device))
        return bce_loss(logits, inside.any(dim=-1).to(logits.dtype))


def dataio_prepare(hparams, key="speech", provides="speech_intervals",
                   columns=2):
    """Train and valid datasets of whole recordings and their first
    ``max_intervals`` intervals (the manifest's ``key``) as a zero-padded
    (max_intervals, ``columns``) array under ``provides``."""
    datasets = {}
    max_int = hparams.get("max_intervals", 8)

    def intervals_pipeline(intervals):
        arr = np.zeros((max_int, columns), np.float32)
        for i, row in enumerate(intervals[:max_int]):
            arr[i] = row
        return arr

    for split, ann in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[ann], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        ds.add_dynamic_item(intervals_pipeline, takes=key, provides=provides)
        ds.set_output_keys(["id", "sig", provides])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=VADBrain, export_from=None,
        prepare=dataio_prepare):
    """The script after the YAML step: datasets (``prepare``), then
    ``fit`` with Adam at ``lr`` and a shuffled train loader; where
    ``export_from`` gives the run's ``(yaml text, overrides)``, the best
    checkpoint is exported to ``pretrained_folder``. Returns the Brain."""
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
    if export_from is not None and "pretrained_folder" in hparams:
        export_frame_model(hparams, *export_from)
    return brain


def main(argv=None, run_fn=run, prepare_corpus=prepare_synthetic):
    """Parse the command line, load the YAML (``--device`` goes to every
    module it builds), make a synthetic corpus under ``--debug`` where the
    train manifest is missing (``prepare_corpus``), then ``run_fn``."""
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
        prepare_corpus(hparams["data_folder"])
    return run_fn(hparams, run_opts, export_from=(text, overrides))


if __name__ == "__main__":
    main(sys.argv[1:])
