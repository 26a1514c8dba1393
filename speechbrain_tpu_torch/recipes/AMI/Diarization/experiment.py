#!/usr/bin/env python
"""AMI speaker diarization on the PyTorch port, the twin of
``recipes/AMI/Diarization/experiment.py``: slide a window over each
recording, embed each window alone with the YAML's embedder (random
weights, or a pretrained state dict given to its ``pretrainer``),
spectral-cluster the affinity matrix, merge adjacent windows of one
speaker, write RTTM, and score DER against the recording's turns.

Run from the repository's root (a synthetic two-speaker meeting is made
under ``--debug`` where ``meetings.json`` is missing):

    python -m speechbrain_tpu_torch.recipes.AMI.Diarization.experiment \\
        speechbrain_tpu_torch/recipes/AMI/Diarization/hparams/ecapa.yaml \\
        --data_folder=results/ami_data --debug --device=cpu
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from speechbrain_tpu_torch.alignment.diarization import (
    do_spec_clustering,
    merge_ssegs_same_speaker,
    write_rttm,
)
from speechbrain_tpu_torch.core import (
    create_experiment_directory,
    parse_arguments,
)
from speechbrain_tpu_torch.dataio.dataio import read_audio, write_audio
from speechbrain_tpu_torch.utils.DER import DER


def prepare_synthetic(data_folder, sample_rate=16000, seed=0):
    """A 6-second 'meeting': speaker A (low tone) then B (high tone),
    alternating 1.5 s turns."""
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    T = 6 * sample_rate
    t = np.arange(T) / sample_rate
    sig = 0.01 * rng.standard_normal(T).astype(np.float32)
    turns = []
    for k in range(4):
        start, end = 1.5 * k, 1.5 * (k + 1)
        spk = "A" if k % 2 == 0 else "B"
        f = 220 if spk == "A" else 660
        seg = (t >= start) & (t < end)
        sig[seg] += 0.5 * np.sin(2 * np.pi * f * t[seg]).astype(np.float32)
        turns.append({"start": start, "end": end, "spk": spk})
    write_audio(str(root / "meeting.wav"), sig, sample_rate)
    with open(root / "meetings.json", "w") as f:
        json.dump({"meeting": {"wav": str(root / "meeting.wav"),
                               "turns": turns}}, f, indent=1)


@torch.no_grad()
def embed_windows(model, hparams, sig, sample_rate):
    """Slide a window of ``window_s`` every ``hop_s`` over ``sig`` (a 1-D
    tensor on the model's device), the last ending at or before its end;
    embed each window alone. Returns ((n, D) float64 numpy embeddings,
    ``[start_s, end_s]`` a window)."""
    win = int(hparams["window_s"] * sample_rate)
    hop = int(hparams["hop_s"] * sample_rate)
    fbank = hparams["compute_features"]
    embs, segs = [], []
    for start in range(0, max(len(sig) - win + 1, 1), hop):
        feats = fbank(sig[None, start: start + win])
        embs.append(model(feats).reshape(-1))
        segs.append([start / sample_rate, (start + win) / sample_rate])
    return torch.stack(embs).double().cpu().numpy(), segs


def cluster_windows(embs, segs, hparams, device):
    """Windows' embeddings clustered (the YAML's oracle number of
    speakers, or the eigengap's estimate where null) and the windows of
    one speaker merged: ``[(start_s, end_s, label)]``."""
    labels = do_spec_clustering(
        embs,
        n_speakers=hparams.get("oracle_n_speakers"),
        pval=hparams["pval"],
        max_speakers=hparams["max_speakers"],
        device=device,
    )
    return merge_ssegs_same_speaker(
        [(s[0], s[1], int(lab)) for s, lab in zip(segs, labels)])


def diarize(model, hparams, sig, device):
    """One recording, windows embedded and clustered: ``(segments,
    windows)``."""
    embs, segs = embed_windows(model, hparams, torch.as_tensor(sig).to(
        device), hparams["sample_rate"])
    return cluster_windows(embs, segs, hparams, device), len(segs)


def main(argv=None):
    """The script: parse the command line, load the YAML (``--device``
    goes to every module it builds), make the synthetic meeting under
    ``--debug`` where ``meetings.json`` is missing, load the embedder's
    weights where the YAML has a ``pretrainer``, then diarize and score
    each meeting. Returns ``{rec_id: {"der", "rttm", "segments",
    "windows"}}``."""
    hparams_file, run_opts, overrides = parse_arguments(argv)
    device = run_opts.get("device", "cuda")
    overrides["device"] = device
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    text = Path(hparams_file).read_text(encoding="utf-8")
    hparams = load_hyperpyyaml(text, overrides)
    create_experiment_directory(
        experiment_directory=hparams["output_folder"],
        hyperparams_to_save=hparams_file,
        overrides=overrides,
    )
    meta = Path(hparams["data_folder"]) / "meetings.json"
    if not meta.exists() and run_opts.get("debug"):
        prepare_synthetic(hparams["data_folder"])
    with open(meta, encoding="utf-8") as f:
        meetings = json.load(f)

    model = hparams["embedding_model"]
    if hparams.get("pretrainer") is not None:
        pre = hparams["pretrainer"]
        pre.add_loadables({"embedding_model": model})
        pre.collect_files()
        pre.load_collected()
    model.to(device).eval()

    save = Path(hparams["save_folder"])
    save.mkdir(parents=True, exist_ok=True)
    results = {}
    for rec_id, rec in meetings.items():
        sig = read_audio(rec["wav"])
        segments, windows = diarize(model, hparams, sig, device)
        rttm_path = save / f"{rec_id}.rttm"
        write_rttm(segments, rec_id, str(rttm_path))
        ref = [(turn["start"], turn["end"], turn["spk"])
               for turn in rec["turns"]]
        hyp = [(s, e, str(lab)) for s, e, lab in segments]
        der = DER(ref, hyp)
        results[rec_id] = {"der": der, "rttm": str(rttm_path),
                           "segments": segments, "windows": windows}
        print(f"{rec_id}: DER {der:.3f} -> {rttm_path}")
    print(f"avg DER {np.mean([r['der'] for r in results.values()]):.3f}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
