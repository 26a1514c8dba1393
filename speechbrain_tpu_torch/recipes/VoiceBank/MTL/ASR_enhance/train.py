#!/usr/bin/env python
"""VoiceBank multi-task robust ASR on the PyTorch port, the twin of
``recipes/VoiceBank/MTL/ASR_enhance/train.py``: a spectral-mask
enhancement model and a CRDNN + CTC perceptual/ASR model trained
together by ``Brain.fit``, the loss ``enhance_weight`` times the L1 of
the enhanced against the clean magnitudes, plus ``mimic_weight`` times the
MSE between the perceptual model's hidden states of the enhanced and of
the clean speech (the latter in evaluation mode, with no gradient), plus
``ctc_weight`` times CTC on the enhanced speech's features.

Three stages, one YAML each: ``pretrain_perceptual.yaml``
(``perceptual_only``: the CRDNN trains by CTC on clean speech, the
enhancement bypassed), ``enhance_mimic.yaml`` (no CTC) and
``robust_asr.yaml`` (all three terms). Where a gradient reaches the
features' waveform (the enhanced speech), the YAML's ``Fbank`` is the
unfused, differentiable one; ``pretrain_perceptual.yaml`` runs the fused
kernel (B3), whose wrapper refuses an input that requires grad.

Run from the repository's root (a synthetic corpus is made under
``--debug`` where the manifest is missing):

    python -m speechbrain_tpu_torch.recipes.VoiceBank.MTL.ASR_enhance.train \\
        speechbrain_tpu_torch/recipes/VoiceBank/MTL/ASR_enhance/hparams/robust_asr.yaml \\
        --data_folder=results/mtl_data --debug --device=cpu
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.core import Brain, Stage
from speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.nnet.losses import ctc_loss
from speechbrain_tpu_torch.processing.signal_processing import resynthesize
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN.train import (
    PAD_TO_MULTIPLE,
    evaluating,
)
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)


class MTLBrain(Brain):
    """Enhancement, mimic and CTC losses over ``enhance_model``,
    ``asr_model`` and ``ctc_head``."""

    def spec_mag(self, wavs):
        return torch.sqrt(self.hparams.compute_stft.power(wavs) + 1e-8)

    def _perceive(self, wavs):
        """Features -> CRDNN -> (hidden states, CTC log-probs)."""
        feats = self.hparams.compute_features(wavs)
        hidden = self.modules.asr_model(feats)
        hidden = hidden[0] if isinstance(hidden, tuple) else hidden
        logits = self.modules.ctc_head(hidden)
        return hidden, torch.log_softmax(logits.float(), dim=-1)

    def compute_forward(self, batch, stage):
        noisy = batch["noisy_sig"].data
        clean = batch["clean_sig"].data
        if getattr(self.hparams, "perceptual_only", False):
            clean_mag = self.spec_mag(clean)
            hidden, p_ctc = self._perceive(clean)
            return clean_mag, clean_mag, hidden, hidden.detach(), p_ctc
        noisy_mag = self.spec_mag(noisy)
        est_mag = noisy_mag * self.modules.enhance_model(noisy_mag)
        est_wav = resynthesize(est_mag, noisy, self.hparams.compute_stft,
                               self.hparams.compute_istft)
        est_hidden, p_ctc = self._perceive(est_wav)
        # the clean speech's hidden states: the mimic target, frozen
        with torch.no_grad(), evaluating(self.modules.asr_model):
            clean_hidden, _ = self._perceive(clean)
        return est_mag, self.spec_mag(clean), est_hidden, clean_hidden, p_ctc

    def compute_objectives(self, predictions, batch, stage):
        est_mag, clean_mag, est_hidden, clean_hidden, p_ctc = predictions
        wav_lens = batch["noisy_sig"].lengths
        chars, char_lens = batch["char_encoded"]
        enhance = torch.mean(torch.abs(est_mag.float() - clean_mag))
        mimic = torch.mean((est_hidden.float() - clean_hidden.float()) ** 2)
        asr = ctc_loss(p_ctc, chars, wav_lens, char_lens,
                       blank_index=self.hparams.blank_index)
        loss = (self.hparams.enhance_weight * enhance
                + self.hparams.mimic_weight * mimic
                + self.hparams.ctc_weight * asr)
        return loss, {"enhance": enhance, "mimic": mimic, "ctc": asr}

    def on_stage_end(self, stage, stage_loss, epoch=None):
        if stage != Stage.VALID:
            return
        self.hparams.train_logger.log_stats(
            stats_meta={"epoch": epoch},
            train_stats={"loss": self.train_loss},
            valid_stats={"loss": stage_loss}, verbose=False)
        self.save_checkpoint(meta={"loss": stage_loss}, min_keys=["loss"])


def prepare_synthetic(data_folder, n_utts=8, sample_rate=16000, seed=0,
                      words=("clean", "speech", "now")):
    """``n_utts`` pairs of two 0.3 s tones, one a word (``250 + 80 w``
    Hz), their transcript the two words, and the same plus white noise at
    0.25; the last two are the valid split. Manifests ``{utt: {clean_wav,
    noisy_wav, words, length}}``. The JAX script's corpus, byte for
    byte."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = list(words)
    manifests = {"train": {}, "valid": {}}
    for i in range(n_utts):
        idx = [(i + j) % len(words) for j in range(2)]
        clean = np.concatenate([
            np.sin(2 * np.pi * (250 + 80 * w)
                   * np.arange(4800) / sample_rate)
            for w in idx
        ]).astype(np.float32) * 0.5
        noisy = clean + 0.25 * rng.standard_normal(len(clean)).astype(
            np.float32)
        cp, npth = root / f"c{i}.wav", root / f"n{i}.wav"
        write_audio(str(cp), clean, sample_rate)
        write_audio(str(npth), noisy, sample_rate)
        split = "valid" if i >= n_utts - 2 else "train"
        manifests[split][f"u{i}"] = {
            "clean_wav": str(cp), "noisy_wav": str(npth),
            "words": " ".join(words[w] for w in idx),
            "length": len(clean) / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(root / f"{split}.json", "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def dataio_prepare(hparams):
    """Train and valid datasets of the noisy and clean signals and the
    transcript's characters (``char_encoded``); the YAML's
    ``label_encoder`` is made from the train split (or loaded from
    ``save_folder``) with ``blank_index`` as its blank."""
    datasets = {}
    encoder = hparams["label_encoder"]
    for split, key in (("train", "train_annotation"),
                       ("valid", "valid_annotation")):
        ds = DynamicItemDataset.from_json(
            hparams[key], replacements={"data_root": hparams["data_folder"]})
        ds.add_dynamic_item(read_audio, takes="noisy_wav",
                            provides="noisy_sig")
        ds.add_dynamic_item(read_audio, takes="clean_wav",
                            provides="clean_sig")
        ds.add_dynamic_item(lambda words: list(words), takes="words",
                            provides="char_list")
        datasets[split] = ds
    encoder.load_or_create(
        path=f"{hparams['save_folder']}/label_encoder.txt",
        from_didatasets=[datasets["train"]],
        output_key="char_list",
        sequence_input=True,
        special_labels={"blank_label": hparams["blank_index"]},
    )
    for ds in datasets.values():
        ds.add_dynamic_item(lambda cl: encoder.encode_sequence_array(cl),
                            takes="char_list", provides="char_encoded")
        ds.set_output_keys(["id", "noisy_sig", "clean_sig", "char_encoded"])
    return datasets


def run(hparams, run_opts, brain_cls=MTLBrain, export_from=None):
    """The script after the YAML step: datasets, then ``fit`` with Adam at
    ``lr``, a shuffled train loader, both loaders padding to 2048 samples.
    Returns the Brain."""
    Path(hparams["save_folder"]).mkdir(parents=True, exist_ok=True)
    datasets = dataio_prepare(hparams)
    lr = hparams["lr"]
    brain = brain_cls(
        modules=hparams["modules"],
        opt_class=lambda params: torch.optim.Adam(params, lr=lr),
        hparams=hparams, run_opts=run_opts,
        checkpointer=hparams["checkpointer"])
    loader = {"batch_size": hparams["batch_size"],
              "pad_to_multiple": PAD_TO_MULTIPLE}
    brain.fit(hparams["epoch_counter"], datasets["train"], datasets["valid"],
              train_loader_kwargs=dict(loader, shuffle=True),
              valid_loader_kwargs=loader)
    return brain


def prepare_corpus(hparams):
    """The ``--debug`` corpus in ``data_folder``."""
    prepare_synthetic(hparams["data_folder"])


def main(argv=None, run_fn=run, prepare_corpus=prepare_corpus):
    return spectral_mask.main(argv, run_fn=run_fn,
                              prepare_corpus=prepare_corpus)


if __name__ == "__main__":
    main(sys.argv[1:])
