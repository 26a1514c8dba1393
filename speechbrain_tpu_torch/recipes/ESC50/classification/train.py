#!/usr/bin/env python
"""ESC-50 environmental sound classification on the PyTorch port, the twin
of ``recipes/ESC50/classification/train.py``: Fbank -> an encoder (Cnn14,
the PIQ ``Conv2dEncoder_v2``, ``FocalNetEncoder`` or ``ViTEncoder``) ->
the recipe's mean pooling -> a linear classifier, NLL over the sound
classes, Adam, a checkpoint kept by the lowest valid loss.

The pooling is the JAX script's (its ``compute_forward``): the mean over
every output frame (time), or over both map axes of a 4-D output, ViT's
CLS token and the frames of padding included; a ViT's attention maps are
dropped. Here it is a module, :class:`PooledEncoder`, which each YAML
names as the ``embedding_model`` of its ``modules``, so that the
export (``utils/pretrained.export_classifier``) is served by
``AudioClassifier.from_hparams`` as it was trained, one vector a clip.

Run from the repository's root (a synthetic sound set is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.ESC50.classification.train \\
        speechbrain_tpu_torch/recipes/ESC50/classification/hparams/cnn14.yaml \\
        --data_folder=results/esc50_data --debug --device=cpu
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
from speechbrain_tpu_torch.nnet.losses import classification_error, nll_loss
from speechbrain_tpu_torch.recipes.ESC50.classification.prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.pretrained import export_classifier


class PooledEncoder(torch.nn.Module):
    """An encoder followed by the recipe's pooling: (B, T, F) features ->
    (B, 1, D). A tuple output (ViT's ``(tokens, attns)``) gives its first
    element; a 4-D map is averaged over both of its map axes, a 3-D one
    over time. ``lengths`` is taken, as the classification interface
    passes it, and ignored: the recipe pools every frame, padding
    included."""

    def __init__(self, encoder):
        super().__init__()
        self.encoder = encoder

    def forward(self, feats, lengths=None):
        emb = self.encoder(feats)
        emb = emb[0] if isinstance(emb, tuple) else emb
        if emb.ndim == 4:
            return emb.mean(dim=(1, 2))[:, None]
        return emb.mean(dim=1, keepdim=True)


class SoundBrain(Brain):
    """Fbank -> pooled encoder -> classifier -> log-softmax -> NLL."""

    def compute_forward(self, batch, stage):
        wavs, _ = batch["sig"]
        feats = self.hparams.compute_features(wavs)
        logits = self.modules.classifier(self.modules.embedding_model(feats))
        # a Linear head gives (B, 1, C), an ECAPA Classifier (B, C)
        if logits.ndim == 3:
            logits = logits[:, 0]
        return torch.log_softmax(logits.float(), dim=-1)

    def compute_objectives(self, logp, batch, stage):
        cls = batch["class_encoded"].data.reshape(-1)
        return nll_loss(logp, cls), {"error": classification_error(logp, cls)}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage == Stage.VALID:
            self.hparams.train_logger.log_stats(
                stats_meta={"epoch": epoch},
                train_stats={"loss": self.train_loss},
                valid_stats={"loss": stage_loss}, verbose=False,
            )
            self.save_checkpoint(meta={"loss": stage_loss},
                                 min_keys=["loss"])


def dataio_prepare(hparams, label_key="class_name"):
    """Train and valid datasets of whole clips and their encoded labels
    (``<label_key>_encoded`` under the name the Brain reads,
    ``class_encoded``); the label encoder is built from the train split or
    loaded from ``save_folder``."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key=label_key,
    )
    for ds in datasets.values():
        ds.add_dynamic_item(lambda c: encoder.encode_label(c),
                            takes=label_key, provides="class_encoded")
        ds.set_output_keys(["id", "sig", "class_encoded"])
    return datasets


def run(hparams, run_opts, brain_cls=SoundBrain, export_from=None,
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
        export_classifier(hparams, *export_from)
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
