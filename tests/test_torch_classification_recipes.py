"""The sound-classification twins against the JAX package's recipes
(``recipes/ESC50/classification``, ``UrbanSound8k/SoundClassification``,
``CommonLanguage/lang_id``, ``VoxLingua107/lang_id``,
``IEMOCAP/emotion_recognition``), each imported as it is:

* ``prepare_synthetic`` against JAX's, files and manifests byte for byte;
* every twin YAML's values against the JAX YAML's, read as text, and its
  modules built on the CPU at the JAX YAML's full width, weight for weight
  (a draw in the shapes of the JAX recipe's parameter tree loads into them
  with no key missing or left over);
* each twin's first float32 loss within 1e-4 relative of the JAX recipe's
  Brain on the same batch of 4 and the same weights (the JAX YAML's
  unfused Fbank against the twin's fused one, whose CPU arm is B3's plain
  version), at a cut width;
* one CLI run of the ESC50 CNN14 twin under ``--debug`` (in a subprocess
  started before the first test), and an in-process run whose export
  ``AudioClassifier.from_hparams`` serves with the trained modules'
  output;
* ``chip_smoke.py``'s ``classify_path`` on the CPU at a cut width
  (``torch.cuda``'s timing calls stubbed, the fused Fbank's plain version
  counted as its launches).
"""

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
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.inference.classifiers import (
    AudioClassifier,
    EncoderClassifier,
)
from speechbrain_tpu_torch.ops import mel_frontend
from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id import (
    prepare as cl_prepare,
)
from speechbrain_tpu_torch.recipes.CommonLanguage.lang_id import (
    train as cl_train,
)
from speechbrain_tpu_torch.recipes.ESC50.classification import (
    prepare as esc50_prepare,
)
from speechbrain_tpu_torch.recipes.ESC50.classification import (
    train as esc50_train,
)
from speechbrain_tpu_torch.recipes.IEMOCAP.emotion_recognition import (
    prepare as iemocap_prepare,
)
from speechbrain_tpu_torch.recipes.IEMOCAP.emotion_recognition import (
    train as iemocap_train,
)
from speechbrain_tpu_torch.recipes.UrbanSound8k.SoundClassification import (
    prepare as us8k_prepare,
)
from speechbrain_tpu_torch.recipes.UrbanSound8k.SoundClassification import (
    train as us8k_train,
)
from speechbrain_tpu_torch.recipes.VoxLingua107.lang_id import (
    prepare as vl_prepare,
)
from speechbrain_tpu_torch.recipes.VoxLingua107.lang_id import (
    train as vl_train,
)
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_rnn import draw_from_shapes
from test_torch_speaker_recipe import _Event

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "recipes"
TWIN = ROOT / "speechbrain_tpu_torch" / "recipes"
LOSS_RTOL = 1e-4
SR = 16000

# recipe folder: (twin prepare, twin train, JAX Brain's name)
RECIPES = {
    "ESC50/classification": (esc50_prepare, esc50_train, "SoundBrain"),
    "UrbanSound8k/SoundClassification": (us8k_prepare, us8k_train,
                                         "SoundBrain"),
    "CommonLanguage/lang_id": (cl_prepare, cl_train, "LangIdBrain"),
    "VoxLingua107/lang_id": (vl_prepare, vl_train, "LangIdBrain"),
    "IEMOCAP/emotion_recognition": (iemocap_prepare, iemocap_train,
                                    "EmoBrain"),
}
TINY_ECAPA = [("(1024, 1024, 1024, 1024, 3072)", "(16, 16, 16, 16, 48)"),
              ("(512, 512, 512, 512, 1536)", "(16, 16, 16, 16, 48)")]
# twin YAML: (recipe folder, text edits, overrides) at the cut width
TWINS = {
    "esc50_cnn14": ("ESC50/classification", "cnn14.yaml", [],
                    {"emb_dim": 16, "base_channels": 2}),
    "esc50_conv2d": ("ESC50/classification", "conv2d.yaml", [],
                     {"emb_dim": 8}),
    "esc50_focalnet": ("ESC50/classification", "focalnet.yaml", [],
                       {"emb_dim": 16, "focal_dims": [8, 12, 16]}),
    "esc50_vit": ("ESC50/classification", "vit.yaml", [],
                  {"emb_dim": 16, "vit_layers": 1, "vit_nhead": 2,
                   "vit_d_ffn": 16}),
    "us8k_cnn14": ("UrbanSound8k/SoundClassification", "cnn14.yaml", [],
                   {"emb_dim": 16, "base_channels": 2}),
    "us8k_ecapa": ("UrbanSound8k/SoundClassification",
                   "train_ecapa_tdnn.yaml", TINY_ECAPA, {}),
    "common_language": ("CommonLanguage/lang_id", "train_ecapa.yaml",
                        TINY_ECAPA, {"emb_dim": 12}),
    "voxlingua107": ("VoxLingua107/lang_id", "train_ecapa.yaml",
                     TINY_ECAPA, {"emb_dim": 12}),
    "iemocap_ecapa": ("IEMOCAP/emotion_recognition", "train_ecapa.yaml",
                      TINY_ECAPA, {"emb_dim": 12}),
    "iemocap_xvector": ("IEMOCAP/emotion_recognition", "train_xvector.yaml",
                        [], {"emb_dim": 12}),
}


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _edited(text, edits):
    for old, new in edits:
        text = text.replace(old, new)
    return text


def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text (a repeated
    key keeps its last value, as the loaders do)."""
    values = {}
    for line in Path(path).read_text().splitlines():
        m = re.match(r"^(\w+): ([^!#\n]+?)\s*(#.*)?$", line)
        if m:
            try:
                values[m.group(1)] = json.loads(m.group(2))
            except ValueError:
                values[m.group(1)] = m.group(2)
    return values


def _trained(h):
    """The modules that JAX's parameter tree keys: the YAML's own
    encoder (the twin's ``modules`` wrap it with the recipe's pooling)
    and its classifier."""
    return {"embedding_model": h["embedding_model"],
            "classifier": h["classifier"]}


# -- data preparation --------------------------------------------------------

@pytest.mark.parametrize("recipe", list(RECIPES))
def test_prepare_synthetic_matches_jax(recipe, tmp_path):
    jax_prep = _load_script(JAX / recipe / "prepare.py",
                            "jax_prepare_" + recipe.replace("/", "_"))
    jax_prep.prepare_synthetic(tmp_path / "jax")
    RECIPES[recipe][0].prepare_synthetic(tmp_path / "torch")
    for name in ("train.json", "valid.json"):
        j = json.loads((tmp_path / "jax" / name).read_text())
        t = json.loads((tmp_path / "torch" / name).read_text())
        assert list(j) == list(t) and len(j) >= 4
        for key in j:
            jw, tw = Path(j[key].pop("wav")), Path(t[key].pop("wav"))
            assert j[key] == t[key]
            assert jw.name == tw.name
            assert jw.read_bytes() == tw.read_bytes()


# -- the YAMLs ---------------------------------------------------------------

@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_yaml_values_are_the_jax_yamls(twin):
    """Every top-level scalar of the JAX YAML is the twin's (the twin adds
    ``device``); every Fbank the twin builds is fused; the literal widths
    match."""
    recipe, yaml, _, _ = TWINS[twin]
    jpath, tpath = JAX / recipe / "hparams" / yaml, \
        TWIN / recipe / "hparams" / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    t.pop("device")
    assert t == j
    text = tpath.read_text()
    fbanks = re.findall(r"Fbank\n((?:  .*\n)+)", text)
    assert fbanks and all("fused: True" in f for f in fbanks)
    tuples = re.findall(r"!tuple \([^)]*\)", jpath.read_text())
    assert tuples == re.findall(r"!tuple \([^)]*\)", text)


def _jax_brain(twin, tmp, edits=None, overrides=None):
    """The JAX recipe's Brain from its YAML (``edits`` to the text,
    ``overrides``), its datasets, and weights drawn in the shapes of its
    ``init_forward`` on a zero batch of 4 one-second clips."""
    recipe, yaml, tiny_edits, tiny = TWINS[twin]
    edits = tiny_edits if edits is None else edits
    overrides = tiny if overrides is None else overrides
    script = _load_script(JAX / recipe / "train.py",
                          "jax_train_" + recipe.replace("/", "_"))
    jh = jax_load(_edited((JAX / recipe / "hparams" / yaml).read_text(),
                          edits),
                  dict(overrides, data_folder=str(tmp / "data"),
                       output_folder=str(tmp / "jax")))
    os.makedirs(jh["save_folder"], exist_ok=True)
    brain = getattr(script, RECIPES[recipe][2])(
        modules=jh["modules"], opt_class=lambda: optax.adam(jh["lr"]),
        hparams=jh, run_opts={"noprogressbar": True},
        checkpointer=jh["checkpointer"])
    fake = {"sig": (jnp.zeros((4, SR)), jnp.ones(4))}
    shapes = jax.eval_shape(lambda rng: brain.init_forward(rng, fake),
                            jax.random.PRNGKey(0))
    return script, jh, brain, draw_from_shapes(shapes, seed=3)


@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_yaml_builds_the_jax_recipes_weights(twin, tmp_path):
    """At the JAX YAML's full width: the JAX recipe's parameter tree (and
    running statistics) loads into the twin YAML's modules, every key
    used and every shape equal."""
    recipe, yaml, _, _ = TWINS[twin]
    _, jh, _, variables = _jax_brain(twin, tmp_path, edits=[], overrides={})
    th = load_hyperpyyaml((TWIN / recipe / "hparams" / yaml).read_text(), {
        "data_folder": str(tmp_path / "data"),
        "output_folder": str(tmp_path / "torch"), "device": "cpu"})
    load_modules(_trained(th), variables)
    n = sum(p.numel() for m in _trained(th).values() for p in m.parameters())
    assert n == sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"]))


# -- the first loss against the JAX recipe's ------------------------------

@pytest.mark.parametrize("twin", list(TWINS))
def test_first_loss_matches_the_jax_recipe(twin, tmp_path):
    """The first train batch of 4 (unshuffled) through each package's
    Brain in training mode, the same weights: the float32 losses within
    1e-4 relative."""
    recipe, yaml, edits, overrides = TWINS[twin]
    RECIPES[recipe][0].prepare_synthetic(tmp_path / "data")
    script, jh, jb, variables = _jax_brain(twin, tmp_path)
    jdata = script.dataio_prepare(jh)
    raw = next(iter(jax_make_dataloader(jdata["train"], batch_size=4)))
    jbatch = jb._prepare_batch(raw)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = {k: jax.tree_util.tree_map(jnp.asarray, v)
             for k, v in variables.items() if k != "params"}
    jloss, _ = jax.jit(lambda p, s: jb._loss_and_aux(
        p, s, jbatch, JaxStage.TRAIN, jb.rng))(params, state)

    th = load_hyperpyyaml(
        _edited((TWIN / recipe / "hparams" / yaml).read_text(), edits),
        dict(overrides, data_folder=str(tmp_path / "data"),
             output_folder=str(tmp_path / "torch"), device="cpu"))
    load_modules(_trained(th), variables)
    brain_cls = getattr(RECIPES[recipe][1], RECIPES[recipe][2])
    label_key = {"CommonLanguage/lang_id": "language",
                 "VoxLingua107/lang_id": "language",
                 "IEMOCAP/emotion_recognition": "emo"}.get(recipe,
                                                           "class_name")
    os.makedirs(th["save_folder"], exist_ok=True)
    pdata = esc50_train.dataio_prepare(th, label_key=label_key)
    pb = brain_cls(modules=th["modules"], hparams=th,
                   run_opts={"device": "cpu", "noprogressbar": True})
    pb.modules.train()
    batch = pb._prepare_batch(next(iter(pb.make_dataloader(
        pdata["train"], Stage.TRAIN, ckpt_prefix=None, batch_size=4))))
    assert list(batch.id) == list(raw["id"])
    ploss, _ = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                     batch, Stage.TRAIN)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)


# -- the ESC50 CNN14 twin run, exported and served -------------------------

CLI_FLAGS = ["--debug", "--debug_batches=2", "--debug_epochs=1",
             "--batch_size=4", "--emb_dim=16", "--base_channels=2",
             # the synthetic set's classes, so that every output decodes
             f"--n_classes={len(esc50_prepare.CLASSES)}",
             "--noprogressbar", "--device=cpu"]


@pytest.fixture(scope="module", autouse=True)
def esc50_cli(tmp_path_factory):
    """The ESC50 CNN14 twin as a user runs it (``python -m``), in a
    subprocess started before the first test."""
    tmp = tmp_path_factory.mktemp("esc50_cli")
    cmd = [sys.executable, "-m",
           "speechbrain_tpu_torch.recipes.ESC50.classification.train",
           str(TWIN / "ESC50" / "classification" / "hparams" / "cnn14.yaml"),
           f"--data_folder={tmp / 'data'}", f"--output_folder={tmp / 'out'}",
           *CLI_FLAGS]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield tmp, proc
    finally:
        proc.kill()
        proc.communicate()


def test_esc50_cli_run_trains_and_exports(esc50_cli):
    tmp, proc = esc50_cli
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    log = (tmp / "out" / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert np.isfinite(losses).all()
    folder = tmp / "out" / "pretrained"
    assert {"embedding_model.ckpt", "classifier.ckpt", "label_encoder.ckpt",
            "hyperparams.yaml"} <= {p.name for p in folder.iterdir()}
    served = AudioClassifier.from_hparams(source=folder,
                                          savedir=tmp / "served",
                                          run_opts={"device": "cpu"})
    wav = next(iter(json.loads(
        (tmp / "data" / "valid.json").read_text()).values()))["wav"]
    _, score, _, labels = served.classify_file(wav)
    assert torch.isfinite(score).all() and labels[0] in \
        esc50_prepare.CLASSES


@pytest.mark.parametrize("twin,interface,n_classes", [
    ("esc50_cnn14", AudioClassifier, len(esc50_prepare.CLASSES)),
    ("voxlingua107", EncoderClassifier, len(vl_prepare.LANGS))])
def test_export_is_served_as_trained(twin, interface, n_classes, tmp_path):
    """One epoch in process, the export of its checkpoint, and the
    interface's ``from_hparams`` on it: the modules bit for bit, and
    ``classify_batch`` equal to the trained modules' output (the encoder,
    the recipe's pooling, the head) on the same clips."""
    recipe, yaml, edits, overrides = TWINS[twin]
    train = RECIPES[recipe][1]
    text = _edited((TWIN / recipe / "hparams" / yaml).read_text(), edits)
    # as many classes as the synthetic set, so that every output decodes
    overrides = dict(overrides, data_folder=str(tmp_path / "data"),
                     output_folder=str(tmp_path / "out"), device="cpu",
                     number_of_epochs=1, batch_size=4, n_classes=n_classes)
    RECIPES[recipe][0].prepare_synthetic(tmp_path / "data")
    th = load_hyperpyyaml(text, overrides)
    brain = train.run(th, {"device": "cpu", "noprogressbar": True},
                      export_from=(text, overrides))
    served = interface.from_hparams(source=th["pretrained_folder"],
                                    savedir=tmp_path / "served",
                                    run_opts={"device": "cpu"})
    for name in ("embedding_model", "classifier"):
        mine = getattr(brain.modules, name).state_dict()
        theirs = getattr(served.mods, name).state_dict()
        assert mine.keys() == theirs.keys()
        for k, v in theirs.items():
            torch.testing.assert_close(v, mine[k], rtol=0, atol=0)
    wavs = torch.from_numpy(0.3 * np.random.default_rng(2).standard_normal(
        (3, SR)).astype(np.float32))
    lens = torch.tensor([1.0, 0.9, 0.75])
    out_prob, _, index, labels = served.classify_batch(wavs, lens)
    brain.modules.eval()
    with torch.no_grad():
        feats = th["compute_features"](wavs)
        emb = (brain.modules.embedding_model(feats, lengths=lens)
               if twin == "voxlingua107"
               else brain.modules.embedding_model(feats))
        ref = brain.modules.classifier(emb)
        ref = ref[:, 0] if ref.ndim == 3 else ref
    torch.testing.assert_close(out_prob, ref, rtol=0, atol=1e-6)
    assert labels == [th["label_encoder"].decode_ind(int(i)) for i in index]


# -- chip_smoke's classify_path on the CPU -----------------------------------

# widths cut for the CPU (text replacements in every twin YAML the card's
# paths load; the card loads them as they are)
SMALL_TWIN_EDITS = [
    ("emb_dim: 2048", "emb_dim: 16"), ("base_channels: 64",
                                       "base_channels: 2"),
    ("emb_dim: 256", "emb_dim: 16"), ("emb_dim: 384", "emb_dim: 16"),
    ("vit_layers: 6", "vit_layers: 1"), ("vit_d_ffn: 1024",
                                         "vit_d_ffn: 16"),
    ("focal_dims: [96, 192, 384]", "focal_dims: [8, 12, 16]"),
    *TINY_ECAPA,
    ("rnn_neurons: 1024", "rnn_neurons: 16"),
    ("rnn_neurons: 512", "rnn_neurons: 16"),
    ("dnn_neurons: 512", "dnn_neurons: 16"),
    ("dec_neurons: 1024", "dec_neurons: 16"),
    ("dec_neurons: 512", "dec_neurons: 16"),
    ("attn_dim: 512", "attn_dim: 16"), ("rnn_layers: 4", "rnn_layers: 1"),
    ("rnn_layers: 3", "rnn_layers: 1"), ("emb_size: 128", "emb_size: 8"),
    ("output_neurons: 1000", "output_neurons: 24"),
    ("location_kernel: 100", "location_kernel: 11"),
    ("(128, 256)", "(4, 8)"), ("(64, 128)", "(4, 8)"),
]


def on_the_cpu(monkeypatch):
    """``chip_smoke`` on the CPU: CUDA's timing calls on the host's clock,
    the twins' YAMLs cut to ``SMALL_TWIN_EDITS``, and B3's plain version
    counted as its launches (unless ``plain_versions`` swapped the arm)."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "TWIN_YAML_EDITS", SMALL_TWIN_EDITS)
    reference = mel_frontend.fused_fbank_reference
    arm = mel_frontend._fused_fbank_cuda

    def counted(*args):
        if mel_frontend._fused_fbank_cuda is arm:
            mel_frontend.launches += 1
        return reference(*args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    return lines


def test_run_classify_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's classify_path end to end at a cut width: every phase's
    checks hold, and B3 (its plain version, counted) runs once a served
    call and once a batch."""
    lines = on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "CLASSIFY_SERVE", dict(
        clips=2, seconds=1.0, fill=(0.6, 0.98), repeats=1))
    monkeypatch.setattr(chip_smoke, "CLASSIFY_CORPUS", dict(
        train_per_class=4, valid_per_class=1, seconds=1.0))
    monkeypatch.setattr(chip_smoke, "CLASSIFY_B3_SHAPES",
                        ((2, 16000, 80),))
    launches, b3 = chip_smoke.run_classify_path(str(tmp_path), device="cpu")
    by_phase = {line["phase"]: line for line in lines}
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    assert set(b3) == {"2x16000@80"}
    assert launches["serve_cnn14"] == launches["serve_vit"] == 1
    # two steps of 8 and one valid batch of 4 (ESC50), 1 + 1 batches of
    # UrbanSound8k's 8 + 4 clips, 2 + 1 of the lang-id and emotion sets
    assert {k: v for k, v in launches.items() if k.startswith("train")} == {
        "train_esc50_cnn14": 3, "train_esc50_vit": 3,
        "train_esc50_conv2d": 3, "train_esc50_focalnet": 3,
        "train_us8k_cnn14": 2, "train_us8k_ecapa": 2,
        "train_common_language": 3, "train_voxlingua107": 5,
        "train_iemocap_ecapa": 3, "train_iemocap_xvector": 3}
    assert launches["serve_voxlingua107"] == 1
    train = by_phase["classify_train/esc50_cnn14"]
    assert train["batch_shape"] == [8, 16000]
    assert train["forwards"] == {"TRAIN": 2, "VALID": 1}
