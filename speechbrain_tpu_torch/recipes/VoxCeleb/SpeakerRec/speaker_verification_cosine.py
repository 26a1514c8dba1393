#!/usr/bin/env python
"""VoxCeleb speaker verification on the PyTorch port, the twin of
``recipes/VoxCeleb/SpeakerRec/speaker_verification_cosine.py``: embed the
enrol and test utterances of a trials file with a trained embedding model,
score each trial by the cosine of the L2-normalised embeddings (or, with
``scoring: plda``, by a PLDA back end trained on the embeddings of
``plda_train_annotation``), and report EER and minDCF.

Trials file format (``veri_pairs.txt``): ``label enrol_wav test_wav`` a
line, label 1 for one speaker, paths relative to ``data_folder``
(``prepare.write_trials`` writes one). The checkpointer of the YAML names
the ``embedding_model`` file the training YAMLs write; its newest
checkpoint is loaded.

Run from the repository's root after training:

    python -m speechbrain_tpu_torch.recipes.VoxCeleb.SpeakerRec.speaker_verification_cosine \\
        speechbrain_tpu_torch/recipes/VoxCeleb/SpeakerRec/hparams/verification_ecapa.yaml \\
        --output_folder=results/ecapa_voxceleb/1986 --data_folder=... --device=cpu
"""

import json
import sys

import numpy as np
import torch

from speechbrain_tpu_torch.core import parse_arguments
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.processing.PLDA_LDA import PLDA, StatObject
from speechbrain_tpu_torch.utils.metric_stats import EER, minDCF


class Embedder:
    """One utterance's L2-normalised embedding (numpy, cached by path):
    ``read_audio`` -> ``compute_features`` -> ``embedding_model`` in
    evaluation mode on ``device``."""

    def __init__(self, hparams, device):
        self.device = torch.device(device)
        self.features = hparams["compute_features"]
        self.model = hparams["embedding_model"].to(self.device).eval()
        self.cache = {}

    @torch.no_grad()
    def __call__(self, wav_path):
        if wav_path not in self.cache:
            sig = torch.from_numpy(read_audio(wav_path))[None].to(
                self.device)
            emb = self.model(self.features(sig)).reshape(-1).cpu().numpy()
            self.cache[wav_path] = emb / (np.linalg.norm(emb) + 1e-9)
        return self.cache[wav_path]


def train_plda(hparams, embed):
    """A PLDA back end (rank ``plda_rank_f``) trained on the embeddings of
    ``plda_train_annotation``'s utterances, labelled by speaker."""
    with open(hparams["plda_train_annotation"], encoding="utf-8") as f:
        entries = json.load(f)
    vecs = [embed(e["wav"]) for e in entries.values()]
    spks = [e["spk_id"] for e in entries.values()]
    stats = StatObject(np.asarray(spks), np.arange(len(vecs)),
                       stat1=np.asarray(vecs))
    return PLDA(rank_f=hparams.get("plda_rank_f", 100)).plda(stats)


def score_trials(hparams, device="cuda"):
    """Load the newest checkpoint's embedding model and score every trial
    of ``verification_file``; returns ``{"scores", "labels", "eer",
    "threshold", "min_dcf"}``.

    Each utterance is embedded once, then the trials are read off one
    table of scores between the utterances (``PLDA.scoring`` over all of
    them at once): the JAX script scores trial by trial, and
    ``PLDA.score_pair`` inverts two (dim, dim) matrices a call."""
    if hparams["checkpointer"].recover_if_possible() is None:
        raise RuntimeError("no checkpoint found; train first")
    embed = Embedder(hparams, device)
    plda = (train_plda(hparams, embed)
            if hparams.get("scoring", "cosine") == "plda" else None)
    with open(hparams["verification_file"], encoding="utf-8") as f:
        trials = [line.split() for line in f if line.strip()]
    paths = list(dict.fromkeys(p for _, e, t in trials for p in (e, t)))
    index = {p: i for i, p in enumerate(paths)}
    embs = np.stack([embed(f"{hparams['data_folder']}/{p}") for p in paths])
    table = plda.scoring(embs, embs) if plda is not None else embs @ embs.T
    scores = np.asarray([table[index[e], index[t]] for _, e, t in trials],
                        np.float64)
    labels = np.asarray([int(lab) for lab, _, _ in trials])
    eer, thr = EER(scores[labels == 1], scores[labels == 0])
    dcf, _ = minDCF(scores[labels == 1], scores[labels == 0])
    return {"scores": scores, "labels": labels, "eer": eer,
            "threshold": thr, "min_dcf": dcf}


def main(argv=None):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    device = run_opts.get("device", "cuda")
    overrides["device"] = device
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    with open(hparams_file, encoding="utf-8") as f:
        hparams = load_hyperpyyaml(f, overrides)
    result = score_trials(hparams, device)
    print(f"EER: {100 * result['eer']:.2f}%  minDCF: "
          f"{result['min_dcf']:.4f}  (thr {result['threshold']:.3f})")
    return result["eer"]


if __name__ == "__main__":
    main(sys.argv[1:])
