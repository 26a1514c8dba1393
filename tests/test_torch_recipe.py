"""The twin recipe (``speechbrain_tpu_torch/recipes/LibriSpeech``) against
the JAX package's: ``prepare_synthetic`` writes the same manifests and
WAV files; the twin's ``train.py`` runs end to end from its YAML on the
CPU, as a user runs it, at the debug flags of ``tests/recipes/recipes.csv``
(``conformer_small.yaml``, 2 batches of 2, 1 epoch, d_model 32, 2 encoder
layers, 1 decoder layer, vocabulary 32) with ``--device=cpu``; and the
modules its YAML builds have the shapes of the JAX recipe's parameter
tree, loaded through ``utils/jax_bridge``.

The run is checked by what it leaves: the tokenizer's model, the train
log, the resolved ``hyperparams.yaml`` (which loads again, with the
overrides in it) and one checkpoint whose ``meta`` loss is finite. At
those flags BPE with 32 pieces splits the words into more pieces than the
encoder has frames, so CTC cannot align the valid utterances: their CTC
loss is optax's large finite value (log(0) taken as -1e5), as in the JAX
recipe, and the valid loss reads hundreds where it read 0.0 before the
port's ``ctc_loss`` followed optax on such rows (``ROADMAP.md`` C11).
Samples: within one step of 1/32768 (both write 16-bit PCM)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.recipes.LibriSpeech import librispeech_prepare
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train import (
    ids_to_words,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules

ROOT = Path(__file__).resolve().parent.parent
JAX_RECIPE = ROOT / "recipes" / "LibriSpeech"
TWIN = ROOT / "speechbrain_tpu_torch" / "recipes" / "LibriSpeech"
HPARAMS = "hparams/conformer_small.yaml"
# tests/recipes/recipes.csv, the LibriSpeech transformer row
DEBUG_FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=2 "
               "--vocab_size=32 --num_encoder_layers=2 "
               "--num_decoder_layers=1 --d_model=32 --d_ffn=64 "
               "--nhead=4").split()
OVERRIDES = {"batch_size": 2, "vocab_size": 32, "num_encoder_layers": 2,
             "num_decoder_layers": 1, "d_model": 32, "d_ffn": 64,
             "nhead": 4}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def twin_run(tmp_path_factory):
    """The twin's ``train.py`` in a subprocess, started before the first
    test of this file and waited for by the tests that read what it wrote
    (the last ones), so that it runs beside the others."""
    tmp = tmp_path_factory.mktemp("twin")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = ([sys.executable, "-m",
            "speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer.train",
            HPARAMS, f"--data_folder={tmp}/data",
            f"--output_folder={tmp}/out"] + DEBUG_FLAGS + ["--device=cpu"])
    proc = subprocess.Popen(cmd, cwd=TWIN / "ASR" / "transformer", env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        yield tmp / "out", proc
    finally:
        proc.kill()
        proc.communicate()


def _finished(twin_run):
    out, proc = twin_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    return out


def test_prepare_synthetic_writes_the_same_corpus(tmp_path):
    jax_prepare = _module(JAX_RECIPE / "librispeech_prepare.py",
                          "jax_librispeech_prepare")
    for name, prepare in (("jax", jax_prepare.prepare_synthetic),
                          ("torch", librispeech_prepare.prepare_synthetic)):
        prepare(str(tmp_path / name / "data"),
                save_folder=str(tmp_path / name / "manifests"), n_utts=14,
                seed=3)
    for split in ("train", "dev", "test"):
        manifests = [json.loads((tmp_path / name / "manifests" /
                                 f"{split}.json").read_text())
                     for name in ("jax", "torch")]
        assert manifests[0].keys() == manifests[1].keys()
        assert len(manifests[0]) > 0
        for uid, row in manifests[1].items():
            jrow = manifests[0][uid]
            assert row["wav"] == jrow["wav"].replace(
                str(tmp_path / "jax"), str(tmp_path / "torch"))
            assert {k: v for k, v in row.items() if k != "wav"} == \
                {k: v for k, v in jrow.items() if k != "wav"}
            a, b = read_audio(row["wav"]), read_audio(jrow["wav"])
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= 1 / 32768
            assert librispeech_prepare._duration(row["wav"]) == \
                row["length"]


def test_ids_past_the_tokenizers_pieces_decode_as_unknown(tmp_path):
    """The head has 5000 classes and BPE on a small corpus stops far
    short: the TEST stage's decoding maps an id past the pieces to the
    unknown piece instead of failing."""
    manifest = tmp_path / "train.json"
    manifest.write_text(json.dumps({
        f"u{i}": {"words": w} for i, w in enumerate(
            ["ALPHA BRAVO", "BRAVO ALPHA", "ALPHA ALPHA"])}))
    tok = SentencePiece(str(tmp_path), 5000, annotation_train=str(manifest),
                        annotation_read="words", model_type="bpe")
    n = tok.sp.vocab_size()
    ids = tok.sp.encode_as_ids("ALPHA BRAVO")
    assert n < 5000 and ids_to_words(tok, [ids, []]) == [["ALPHA", "BRAVO"],
                                                         []]
    assert ids_to_words(tok, [ids + [n, 4999]]) == [["ALPHA",
                                                      "BRAVO<unk><unk>"]]


def test_yaml_modules_have_the_jax_recipes_shapes(tmp_path):
    """The twin's YAML and the JAX recipe's YAML at the same overrides:
    the JAX recipe's parameter tree (its shapes from ``jax.eval_shape``
    of its ``init_forward``) loads into the modules the twin's YAML
    built, every key used and every shape fitting."""
    overrides = dict(OVERRIDES, data_folder=str(tmp_path),
                     output_folder=str(tmp_path / "out"))
    with open(TWIN / "ASR" / "transformer" / HPARAMS) as f:
        hparams = load_hyperpyyaml(f, dict(overrides, device="cpu"))
    with open(JAX_RECIPE / "ASR" / "transformer" / HPARAMS) as f:
        jax_hparams = jax_load(f, overrides)
    recipe = _module(JAX_RECIPE / "ASR" / "transformer" / "train.py",
                     "jax_librispeech_transformer_train_shapes")
    brain = recipe.ASR(modules=jax_hparams["modules"], hparams=jax_hparams,
                       run_opts={"noprogressbar": True})
    batch = {"sig": (np.zeros((2, 16000), np.float32),
                     np.ones(2, np.float32)),
             "tokens_bos": (np.ones((2, 5), np.int32),
                            np.ones(2, np.float32))}
    shapes = jax.eval_shape(lambda rng: brain.init_forward(rng, batch),
                            jax.random.PRNGKey(0))["params"]
    tree = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    n_params = sum(int(np.prod(a.shape))
                   for a in jax.tree_util.tree_leaves(tree))
    load_modules(hparams["modules"], tree)
    assert n_params == sum(p.numel() for m in hparams["modules"].values()
                           for p in m.parameters())


def test_the_twin_runs_end_to_end_from_its_yaml(twin_run):
    out = _finished(twin_run)
    assert (out / "save" / "32_bpe.model.json").is_file()
    assert (out / "train.py").is_file() and (out / "log.txt").is_file()
    log = (out / "train_log.txt").read_text().splitlines()
    assert log[0].startswith("epoch: 1") and "valid loss" in log[0]
    assert log[1].startswith("epoch loaded: 1") and "test WER" in log[1]
    ckpts = sorted((out / "save").glob("CKPT+*"))
    assert len(ckpts) == 1
    meta = json.loads((ckpts[0] / "CKPT.yaml").read_text())
    assert math.isfinite(meta["loss"]) and meta["end-of-epoch"] is True
    # CTC weight 0.3 of about 1e5 a row over tens of target pieces: the
    # unalignable valid rows count, as optax counts them
    assert meta["loss"] > 100.0
    assert {p.name for p in ckpts[0].iterdir()} == {
        "CKPT.yaml", "brain.ckpt", "modules.ckpt", "optimizer.ckpt",
        "dataloader-TRAIN.ckpt"}
    manifests = json.loads((out / "manifests" / "train.json").read_text())
    assert len(manifests) == 8  # prepare_synthetic's 12, 8 for training


def test_the_resolved_hyperparams_load_again(twin_run):
    out = _finished(twin_run)
    resolved = load_hyperpyyaml(
        (out / "hyperparams.yaml").read_text(),
    )
    for key, value in OVERRIDES.items():
        assert resolved[key] == value, key
    assert resolved["device"] == "cpu"
    assert resolved["output_folder"] == str(out)
    assert resolved["model"].custom_src_module.weight.device.type == "cpu"
