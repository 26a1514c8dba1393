#!/usr/bin/env python
"""TIMIT CRDNN attention seq2seq phoneme recognition on the PyTorch port,
the twin of ``recipes/TIMIT/ASR/seq2seq/train.py``: the LibriSpeech
seq2seq twin's ``ASR`` (Fbank -> sentence normalisation -> CRDNN -> GRU
decoder with location attention, CTC + label-smoothed NLL, Adadelta and
NewBob) over phone ids from a map of the train manifest's phones, sorted
and counted from 3 (0, 1 and 2 are the YAML's blank, BOS and EOS), in
place of a tokenizer; the test split is beam-searched outside ``--debug``
and its phone error rate written to ``wer_test.txt``.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.TIMIT.ASR.seq2seq.train \\
        speechbrain_tpu_torch/recipes/TIMIT/ASR/seq2seq/hparams/train.yaml \\
        --data_folder=results/timit_data --debug --device=cpu
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import (
    train as librispeech,
)
from speechbrain_tpu_torch.recipes.TIMIT.timit_prepare import (
    prepare_synthetic,
)
from speechbrain_tpu_torch.utils.metric_stats import ErrorRateStats

# an unknown phone's id, as the JAX script maps it (the first phone's)
UNKNOWN_PHONE = 3


class ASR(librispeech.ASR):
    """The LibriSpeech twin's Brain; a dataset is scored over phones."""

    @torch.no_grad()
    def transcribe_dataset(self, dataset, phone_map, beam_size=8):
        """Beam-search a dataset (the modules in ``eval()``) and return its
        ``ErrorRateStats`` over phones (an id outside the map reads
        ``?``)."""
        searcher = self.make_searcher(beam_size)
        inverse = {v: k for k, v in phone_map.items()}
        per = ErrorRateStats()
        loader = self.make_dataloader(
            dataset, Stage.TEST, ckpt_prefix=None,
            batch_size=self.hparams.test_batch_size,
        )
        self.modules.eval()
        for batch in loader:
            batch = self._prepare_batch(batch)
            wavs, wav_lens = batch["sig"]
            feats = self.hparams.compute_features(wavs)
            feats = self.hparams.normalize(feats, wav_lens)
            hyps, _, _, _ = searcher(self.modules.enc(feats), wav_lens)
            preds = [[inverse.get(int(t), "?") for t in h] for h in hyps]
            per.append(batch.id, preds, [p.split() for p in batch.phn])
        return per


def build_phone_map(hparams):
    """``{phone: id}`` over the train manifest's phones, sorted, from 3."""
    with open(hparams["train_annotation"], encoding="utf-8") as f:
        items = json.load(f)
    phones = sorted({p for e in items.values() for p in e["phn"].split()})
    return {p: i + 3 for i, p in enumerate(phones)}


def dataio_prepare(hparams, phone_map):
    """Manifests -> datasets that read the audio and map the phones to
    ids (``tokens``, ``tokens_bos``, ``tokens_eos``), the phones kept for
    scoring. The train split is sorted by length; a missing test manifest
    is skipped."""
    datasets = {}
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation"),
                       ("test", "test_annotation")):
        path = hparams[key]
        if not Path(path).exists():
            if split == "test":
                continue
            raise FileNotFoundError(f"{path} missing; run timit_prepare.py "
                                    f"first")
        ds = DynamicItemDataset.from_json(
            path, replacements={"data_root": hparams["data_folder"]})
        if split == "train":
            ds = ds.filtered_sorted(sort_key="length")
        ds.add_dynamic_item(read_audio, takes="wav", provides="sig")

        def tokens_pipeline(phn):
            ids = [phone_map.get(p, UNKNOWN_PHONE) for p in phn.split()]
            yield np.asarray(ids, np.int32)
            yield np.asarray([hparams["bos_index"]] + ids, np.int32)
            yield np.asarray(ids + [hparams["eos_index"]], np.int32)

        ds.add_dynamic_item(tokens_pipeline, takes="phn",
                            provides=["tokens", "tokens_bos", "tokens_eos"])
        ds.set_output_keys(
            ["id", "sig", "phn", "tokens", "tokens_bos", "tokens_eos"])
        datasets[split] = ds
    return datasets


def run(hparams, run_opts, brain_cls=ASR):
    """The chain after the YAML step: a synthetic corpus under ``--debug``
    where the train manifest is missing, the phone map, the datasets,
    ``fit`` (Adadelta, batches padded to whole seconds), then outside
    ``debug`` the test split's phone error rate. Returns ``(brain,
    datasets, phone_map)``."""
    if not Path(hparams["train_annotation"]).exists() and run_opts.get(
            "debug"):
        prepare_synthetic(hparams["data_folder"])
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    phone_map = build_phone_map(hparams)
    datasets = dataio_prepare(hparams, phone_map)
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=librispeech.adadelta(hparams["lr"]),
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams["checkpointer"],
    )
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": {"sig": librispeech.SIG_PAD_MULTIPLE}}
    brain.fit(hparams["epoch_counter"], datasets["train"], datasets["valid"],
              train_loader_kwargs=dict(loader, shuffle=True),
              valid_loader_kwargs=loader)
    if "test" in datasets and not run_opts.get("debug"):
        per = brain.transcribe_dataset(datasets["test"], phone_map,
                                       beam_size=hparams["test_beam_size"])
        with open(Path(hparams["output_folder"]) / "wer_test.txt", "w") as f:
            per.write_stats(f)
    return brain, datasets, phone_map


def main(argv=None):
    return librispeech.main(argv, run_fn=run)


if __name__ == "__main__":
    main(sys.argv[1:])
