"""The TIMIT, CommonVoice, GigaSpeech and VoxPopuli Conformer transducer
twins (``speechbrain_tpu_torch/recipes/<corpus>/ASR/transducer``), one
parametrised case a twin: its YAML's scalars against the JAX recipe's
YAML; the twin run from its YAML in a subprocess at the debug flags of
``tests/recipes/recipes.csv`` (rows 68, 82, 91 and 92) with
``--device=cpu`` (the four started together, at the first case); its
``prepare_synthetic`` against the JAX recipe's, manifests and WAV files
byte for byte; and TIMIT's phone map against the JAX recipe's."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from speechbrain_tpu_torch.recipes.CommonVoice import commonvoice_prepare
from speechbrain_tpu_torch.recipes.GigaSpeech.ASR.CTC import (
    prepare as gigaspeech_prepare,
)
from speechbrain_tpu_torch.recipes.TIMIT import timit_prepare
from speechbrain_tpu_torch.recipes.TIMIT.ASR.transducer import (
    train as timit_train,
)
from speechbrain_tpu_torch.recipes.VoxPopuli.ASR.CTC import (
    prepare as voxpopuli_prepare,
)
from test_torch_seq2seq_recipe import _scalars

ROOT = Path(__file__).resolve().parents[1]
# corpus -> (the JAX prepare module, the port's, recipes.csv's vocabulary)
TWINS = {
    "TIMIT": ("TIMIT/timit_prepare.py", timit_prepare, 45),
    "CommonVoice": ("CommonVoice/commonvoice_prepare.py",
                    commonvoice_prepare, 32),
    "GigaSpeech": ("GigaSpeech/ASR/CTC/prepare.py", gigaspeech_prepare, 32),
    "VoxPopuli": ("VoxPopuli/ASR/CTC/prepare.py", voxpopuli_prepare, 32),
}
# tests/recipes/recipes.csv:68, 82, 91, 92 (the vocabulary above)
FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=2 "
         "--d_model=32 --nhead=4 --d_ffn=64 --num_encoder_layers=2 "
         "--joint_dim=32 --dec_neurons=32 --emb_size=16").split()


def _yaml(corpus, port):
    base = ROOT / "speechbrain_tpu_torch" / "recipes" if port else \
        ROOT / "recipes"
    return base / corpus / "ASR" / "transducer" / "hparams" / \
        "conformer_transducer.yaml"


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four twins started together from their YAMLs; each one's
    completed process and output folder."""
    root = tmp_path_factory.mktemp("twins")
    # two threads each: the four share the machine with each other
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = {}
    for corpus, (_, _, vocab) in TWINS.items():
        out = root / corpus / "out"
        procs[corpus] = (subprocess.Popen(
            [sys.executable, "-m",
             f"speechbrain_tpu_torch.recipes.{corpus}.ASR.transducer.train",
             str(_yaml(corpus, port=True)),
             f"--data_folder={root / corpus / 'data'}",
             f"--output_folder={out}", "--device=cpu", "--noprogressbar",
             f"--vocab_size={vocab}", *FLAGS],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), out)
    results = {}
    for corpus, (proc, out) in procs.items():
        _, err = proc.communicate(timeout=300)
        results[corpus] = (proc.returncode, err, out)
    return results


@pytest.mark.parametrize("corpus", sorted(TWINS))
def test_the_twins_yaml_holds_the_jax_values(corpus):
    twin = _scalars(_yaml(corpus, port=True))
    jax_yaml = _scalars(_yaml(corpus, port=False))
    assert jax_yaml == {k: v for k, v in twin.items() if k != "device"}
    text = _yaml(corpus, port=True).read_text()
    jax_text = _yaml(corpus, port=False).read_text()
    for key in ("output_folder", "valid_annotation"):
        line = re.search(rf"^{key}: .*$", text, re.M)[0]
        assert line == re.search(rf"^{key}: .*$", jax_text, re.M)[0]
    assert "speechbrain_tpu." not in text and "fused: True" in text


@pytest.mark.parametrize("corpus", sorted(TWINS))
def test_the_twin_runs_from_its_yaml(runs, corpus):
    rc, err, out = runs[corpus]
    assert rc == 0, err[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any((out / "save").glob("CKPT*"))


@pytest.mark.parametrize("corpus", sorted(TWINS))
def test_prepare_synthetic_writes_the_jax_corpus(tmp_path, corpus):
    jax_file, port, _ = TWINS[corpus]
    jax_prepare = _module(ROOT / "recipes" / jax_file,
                          f"jax_{corpus.lower()}_prepare")
    folders = {"jax": tmp_path / "jax", "torch": tmp_path / "pyt"}
    jax_prepare.prepare_synthetic(str(folders["jax"]))
    port.prepare_synthetic(str(folders["torch"]))
    names = sorted(p.name for p in folders["jax"].iterdir())
    assert names == sorted(p.name for p in folders["torch"].iterdir())
    manifests = [n for n in names if n.endswith(".json")]
    assert len(manifests) >= 2 and len(names) > len(manifests)
    for name in names:
        want = (folders["jax"] / name).read_bytes()
        got = (folders["torch"] / name).read_bytes()
        if name.endswith(".json"):
            want = want.replace(str(folders["jax"]).encode(),
                                str(folders["torch"]).encode())
        assert got == want, name


def test_the_timit_phone_map_matches_the_jax_recipe(tmp_path):
    jax_train = _module(ROOT / "recipes" / "TIMIT" / "ASR" / "transducer"
                        / "train.py", "jax_timit_transducer_train")
    timit_prepare.prepare_synthetic(str(tmp_path))
    hparams = {"train_annotation": str(tmp_path / "train.json")}
    phone_map = timit_train.build_phone_map(hparams)
    assert phone_map == jax_train.build_phone_map(hparams)
    assert sorted(phone_map.values()) == list(range(1, len(phone_map) + 1))
    labels, takes, encode = timit_train.phone_labels(hparams)
    assert labels == phone_map and takes == "phn"
    for entry in json.loads((tmp_path / "valid.json").read_text()).values():
        want = [phone_map.get(p, 1) for p in entry["phn"].split()]
        np.testing.assert_array_equal(encode(entry["phn"]), want)
    # a phone the map lacks is id 1, as in the JAX recipe
    assert encode("sil zz").tolist() == [phone_map.get("sil", 1), 1]
