#!/usr/bin/env python
"""WSJ0-2mix source separation on the PyTorch port, the twin of
``recipes/WSJ0Mix/separation/train.py``: random aligned crops of
``training_signal_len`` samples of the mixture and both sources, one
seeded numpy generator for all of them (train and valid, in the order the
items are read), a separation model (SepFormer, its Conformer-intra
variant, DPRNN, RE-SepFormer, SkiM or Conv-TasNet, as the YAML names),
the negated PIT SI-SNR over the crops' lengths clamped at
``loss_upper_lim``, Adam, ``ReduceLROnPlateau`` on the valid loss at the
end of each valid stage, and a checkpoint kept by the lowest valid loss.

Run from the repository's root (a synthetic corpus is made, by the
LibriMix twin's ``prepare_synthetic``, beside the save folder under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.WSJ0Mix.separation.train \\
        speechbrain_tpu_torch/recipes/WSJ0Mix/separation/hparams/sepformer.yaml \\
        --data_folder=results/wsj0mix_data --debug --device=cpu
"""

import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import get_si_snr_with_pitwrapper
from speechbrain_tpu_torch.nnet.schedulers import update_learning_rate
from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    train as librimix,
)
from speechbrain_tpu_torch.recipes.LibriMix.separation.prepare import (
    prepare_synthetic,
)


class Separation(librimix.Separation):
    """Mixture -> model -> estimates; the negated PIT SI-SNR of the two
    sources over their lengths, each utterance's clamped at
    ``loss_upper_lim``, then the batch mean."""

    def compute_objectives(self, est, batch, stage):
        targets = torch.stack([batch["s1_sig"].data, batch["s2_sig"].data],
                              dim=-1)
        loss = get_si_snr_with_pitwrapper(targets, est.float(),
                                          batch["s1_sig"].lengths)
        return torch.clamp(loss, max=self.hparams.loss_upper_lim).mean()

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        current_lr = self.optimizer.param_groups[0]["lr"]
        _, new_lr = self.hparams.lr_scheduler(current_lr, epoch, stage_loss)
        update_learning_rate(self.optimizer, new_lr)
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch, "lr": new_lr,
                        "si-snr": -float(stage_loss)},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False,
        )
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def dataio_prepare(hparams):
    """Train and valid datasets of aligned crops (``mix_sig``,
    ``s1_sig``, ``s2_sig``): where the shortest of the three signals is
    longer than ``training_signal_len``, a start drawn from
    ``default_rng(seed)``, else the whole signals."""
    datasets = {}
    L = hparams["training_signal_len"]
    rng = np.random.default_rng(hparams["seed"])

    def triple_pipeline(mix_wav, s1_wav, s2_wav):
        mix, s1, s2 = read_audio(mix_wav), read_audio(s1_wav), \
            read_audio(s2_wav)
        n = min(len(mix), len(s1), len(s2))
        if n > L:
            start = int(rng.integers(0, n - L))
            sl = slice(start, start + L)
        else:
            sl = slice(0, n)
        yield mix[sl]
        yield s1[sl]
        yield s2[sl]

    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(triple_pipeline,
                            takes=["mix_wav", "s1_wav", "s2_wav"],
                            provides=["mix_sig", "s1_sig", "s2_sig"])
        ds.set_output_keys(["id", "mix_sig", "s1_sig", "s2_sig"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=Separation, prepare=dataio_prepare,
        export_from=None):
    """The LibriMix twin's ``run`` with this recipe's Brain, crops and
    checkpoint key (``loss``)."""
    return librimix.run(hparams, run_opts, brain_cls=brain_cls,
                        prepare=prepare, export_from=export_from,
                        min_key="loss")


def prepare_corpus(hparams):
    """The ``--debug`` corpus, beside the train manifest's folder."""
    prepare_synthetic(Path(hparams["train_annotation"]).parent,
                      sample_rate=hparams["sample_rate"])


def main(argv=None):
    return librimix.main(argv, run_fn=run, prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
