"""LibriSpeech data preparation on the PyTorch port (the twin of
``recipes/LibriSpeech/librispeech_prepare.py``): scan the extracted corpus,
or make a small synthetic one, and write JSON manifests for
``DynamicItemDataset``.

Each split manifest maps utterance id ->
{"wav": path, "words": transcript, "length": seconds, "spk_id": str}.
The same seed gives the same manifests and WAV files as the JAX package's.
"""

import json
import os
import wave
from pathlib import Path

import numpy as np

from speechbrain_tpu_torch.dataio.dataio import write_audio

SAMPLERATE = 16000


def prepare_librispeech(
    data_folder,
    save_folder,
    tr_splits=("train-clean-100",),
    dev_splits=("dev-clean",),
    te_splits=("test-clean",),
    merge_train=True,
    skip_prep=False,
):
    """Scan LibriSpeech split dirs and write {split}.json manifests."""
    if skip_prep:
        return
    os.makedirs(save_folder, exist_ok=True)
    split_groups = {
        "train": tr_splits if merge_train else (),
        "dev": dev_splits,
        "test": te_splits,
    }
    if not merge_train:
        for s in tr_splits:
            split_groups[s] = (s,)
    for out_name, splits in split_groups.items():
        if not splits:
            continue
        manifest = {}
        for split in splits:
            root = Path(data_folder) / split
            if not root.is_dir():
                raise FileNotFoundError(f"missing split dir: {root}")
            for trans in sorted(root.rglob("*.trans.txt")):
                chapter_dir = trans.parent
                with open(trans, encoding="utf-8") as f:
                    for line in f:
                        utt_id, words = line.strip().split(" ", 1)
                        flac = chapter_dir / f"{utt_id}.flac"
                        wav = chapter_dir / f"{utt_id}.wav"
                        audio = wav if wav.exists() else flac
                        spk = utt_id.split("-")[0]
                        manifest[utt_id] = {
                            "wav": str(audio),
                            "words": words,
                            "spk_id": spk,
                            "length": _duration(audio),
                        }
        out = Path(save_folder) / f"{out_name}.json"
        with open(out, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


WORDS = ["ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT",
         "GOLF", "HOTEL"]


def prepare_synthetic(data_folder, save_folder=None, n_utts=12,
                      sample_rate=16000, seed=0):
    """Write a small synthetic corpus with LibriSpeech-shaped manifests
    for --debug runs: each vocabulary word maps to a tone of 0.12 s,
    utterances are 2-4 word tone sequences over noise 34 dB down. Every
    sixth utterance from the fifth goes to ``dev``, from the sixth to
    ``test``, the rest to ``train``."""
    save_folder = save_folder or data_folder
    root = Path(data_folder)
    root.mkdir(parents=True, exist_ok=True)
    Path(save_folder).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifests = {"train": {}, "dev": {}, "test": {}}
    for i in range(n_utts):
        n_words = int(rng.integers(2, 5))
        idx = rng.integers(0, len(WORDS), size=n_words)
        words = " ".join(WORDS[j] for j in idx)
        segs = []
        for j in idx:
            t = np.arange(int(0.12 * sample_rate)) / sample_rate
            segs.append(np.sin(2 * np.pi * (300 + 80 * j) * t))
        sig = np.concatenate(segs).astype(np.float32) * 0.5
        sig += 0.01 * rng.standard_normal(len(sig)).astype(np.float32)
        path = root / f"synth_{i}.wav"
        write_audio(str(path), sig, sample_rate)
        split = ("dev" if i % 6 == 4 else "test" if i % 6 == 5 else "train")
        manifests[split][f"synth_{i}"] = {
            "wav": str(path),
            "words": words,
            "spk_id": f"spk{i % 3}",
            "length": len(sig) / sample_rate,
        }
    for split, manifest in manifests.items():
        with open(Path(save_folder) / f"{split}.json", "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)


def _duration(path):
    """Audio length in seconds: WAV from its header, FLAC from a parse of
    its STREAMINFO block; 0.0 where neither reads, so that sorting still
    works."""
    p = str(path)
    try:
        if p.lower().endswith(".wav"):
            with wave.open(p, "rb") as w:
                return w.getnframes() / w.getframerate()
        if p.lower().endswith(".flac"):
            with open(p, "rb") as f:
                if f.read(4) != b"fLaC":
                    return 0.0
                # first metadata block is STREAMINFO
                f.read(4)
                info = f.read(34)
                sr = (info[10] << 12) | (info[11] << 4) | (info[12] >> 4)
                total = ((info[13] & 0x0F) << 32) | int.from_bytes(
                    info[14:18], "big"
                )
                return total / sr if sr else 0.0
    except (OSError, wave.Error):
        pass
    return 0.0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data_folder")
    ap.add_argument("save_folder")
    ap.add_argument("--tr-splits", nargs="+",
                    default=["train-clean-100"])
    args = ap.parse_args()
    prepare_librispeech(args.data_folder, args.save_folder,
                        tr_splits=args.tr_splits)
    print(f"manifests written to {args.save_folder}")
