"""The recurrent seq2seq twins against the JAX package's recipes
(``recipes/CommonVoice/ASR/seq2seq``, ``TIMIT/ASR/seq2seq``,
``Switchboard/ASR/seq2seq``, ``SLURP/direct``), each imported as it is:

* ``prepare_synthetic`` of Switchboard (the CTC folder's, which the
  seq2seq script reads) and of SLURP against JAX's, byte for byte;
* every twin YAML's values against the JAX YAML's, read as text, and its
  modules built on the CPU at the JAX YAML's full width, weight for
  weight (a draw in the shapes of the JAX recipe's parameter tree and
  running statistics loads into them with no key missing or left over);
* each twin's first float32 loss within 1e-4 relative of the JAX recipe's
  Brain on the same batch of 4 and the same weights, at a cut width and
  dropout 0 (one BPE model for both packages: the port's file, which the
  JAX tokenizer loads);
* the SLURP and TIMIT twins run as a user runs them (``python -m``, the
  debug flags), in subprocesses started before the first test;
* ``chip_smoke.py``'s ``recurrent_twins_path`` on the CPU at a cut width.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.tokenizers.SentencePiece import (
    SentencePiece as JaxSentencePiece,
)
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.recipes.CommonVoice.ASR.seq2seq import (
    train as cv_train,
)
from speechbrain_tpu_torch.recipes.CommonVoice.commonvoice_prepare import (
    prepare_synthetic as cv_prepare,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import (
    train as librispeech,
)
from speechbrain_tpu_torch.recipes.SLURP.direct import prepare as slurp_prep
from speechbrain_tpu_torch.recipes.SLURP.direct import train as slurp_train
from speechbrain_tpu_torch.recipes.Switchboard.ASR.CTC import (
    prepare as swbd_prep,
)
from speechbrain_tpu_torch.recipes.Switchboard.ASR.seq2seq import (
    train as swbd_train,
)
from speechbrain_tpu_torch.recipes.TIMIT.ASR.seq2seq import (
    train as timit_train,
)
from speechbrain_tpu_torch.recipes.TIMIT.timit_prepare import (
    prepare_synthetic as timit_prepare,
)
from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_classification_recipes import (
    _load_script,
    _scalars,
    on_the_cpu,
)
from test_torch_rnn import draw_from_shapes

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "recipes"
TWIN = ROOT / "speechbrain_tpu_torch" / "recipes"
LOSS_RTOL = 1e-4
CV = "CommonVoice/ASR/seq2seq"
TIMIT = "TIMIT/ASR/seq2seq"
SWBD = "Switchboard/ASR/seq2seq"
SLURP = "SLURP/direct"
YAMLS = [(CV, f"train{s}.yaml") for s in
         ("", "_de", "_en", "_es", "_fr", "_it", "_rw")] + \
    [(TIMIT, "train.yaml"), (SWBD, "train.yaml"), (SLURP, "train.yaml")]
# the cut width of the loss comparison (dropout 0: the packages draw
# their masks from different generators)
TINY = {"cnn_blocks": 1, "rnn_layers": 1, "rnn_neurons": 16,
        "dnn_blocks": 1, "dnn_neurons": 16, "emb_size": 8,
        "dec_neurons": 16, "attn_dim": 16, "dropout": 0.0}
TINY_LOCATION = {"location_kernel": 11, "location_channels": 4}
# recipe: (twin prepare, twin train module, token source)
TWINS = {
    CV: (lambda d: cv_prepare(str(d)), cv_train, "bpe"),
    TIMIT: (lambda d: timit_prepare(str(d)), timit_train, "phones"),
    SWBD: (lambda d: swbd_prep.prepare_synthetic(d), swbd_train, "bpe"),
    SLURP: (lambda d: slurp_prep.prepare_synthetic(d), slurp_train, "bpe"),
}


@pytest.mark.parametrize("recipe,prepare,manifests", [
    ("Switchboard/ASR/CTC", swbd_prep.prepare_synthetic,
     ("train.json", "valid.json")),
    (SLURP, slurp_prep.prepare_synthetic,
     ("train.json", "devel.json", "test.json"))])
def test_prepare_synthetic_matches_jax(recipe, prepare, manifests,
                                       tmp_path):
    jax_prep = _load_script(JAX / recipe / "prepare.py",
                            "jax_prepare_" + recipe.replace("/", "_"))
    jax_prep.prepare_synthetic(tmp_path / "jax")
    prepare(tmp_path / "torch")
    for name in manifests:
        j = json.loads((tmp_path / "jax" / name).read_text())
        t = json.loads((tmp_path / "torch" / name).read_text())
        assert list(j) == list(t) and len(j) >= 1
        for key in j:
            jw, tw = Path(j[key].pop("wav")), Path(t[key].pop("wav"))
            assert j[key] == t[key] and jw.name == tw.name
            assert jw.read_bytes() == tw.read_bytes()


@pytest.mark.parametrize("recipe,yaml", YAMLS)
def test_twin_yaml_values_are_the_jax_yamls(recipe, yaml):
    """Every top-level scalar of the JAX YAML is the twin's (the twin adds
    ``device``); the Fbank is fused; the literal widths match."""
    jpath, tpath = JAX / recipe / "hparams" / yaml, \
        TWIN / recipe / "hparams" / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    t.pop("device")
    assert t == j
    text = tpath.read_text()
    fbanks = re.findall(r"Fbank\n((?:  .*\n)+)", text)
    assert len(fbanks) == 1 and "fused: True" in fbanks[0]
    tuples = re.findall(r"!tuple \([^)]*\)", jpath.read_text())
    assert tuples == re.findall(r"!tuple \([^)]*\)", text)


def _tokens(recipe, h, tmp):
    """The port's tokenizer (or TIMIT's phone map) over the train
    manifest, and the JAX recipe's from the same model file."""
    kind = TWINS[recipe][2]
    if kind == "phones":
        phone_map = timit_train.build_phone_map(h)
        return phone_map, phone_map
    read = "semantics" if recipe == SLURP else "words"
    tok = SentencePiece(model_dir=str(tmp / "tok"),
                        vocab_size=h["output_neurons"],
                        annotation_train=h["train_annotation"],
                        annotation_read=read, model_type="bpe",
                        annotation_format="json")
    jtok = JaxSentencePiece(model_dir=str(tmp / "tok"),
                            vocab_size=h["output_neurons"], model_type="bpe")
    return tok, jtok


def _pad(recipe):
    return (slurp_train.SIG_PAD_MULTIPLE if recipe == SLURP
            else librispeech.SIG_PAD_MULTIPLE)


def _jax_recipe(recipe, tmp, overrides):
    """The JAX recipe's Brain from its YAML, its datasets over the port's
    tokens, and its first (sorted, unshuffled) train batch of 4, padded as
    the recipe pads."""
    script = _load_script(JAX / recipe / "train.py",
                          "jax_train_" + recipe.replace("/", "_"))
    jh = jax_load((JAX / recipe / "hparams" / "train.yaml").read_text(),
                  dict(overrides, data_folder=str(tmp / "data"),
                       output_folder=str(tmp / "jax")))
    os.makedirs(jh["save_folder"], exist_ok=True)
    tok, jtok = _tokens(recipe, jh, tmp)
    jdata = script.dataio_prepare(jh, jtok)
    name = "SLU" if recipe == SLURP else "ASR"
    jb = getattr(script, name)(
        modules=jh["modules"], hparams=jh, run_opts={"noprogressbar": True},
        opt_class=lambda: optax.adam(1e-3))
    raw = next(iter(jax_make_dataloader(
        jdata["train"], batch_size=4, pad_to_multiple={"sig": _pad(recipe)})))
    return jb, raw, tok


def _variables(jb, raw, seed=3):
    batch = jb._prepare_batch(raw)
    shapes = jax.eval_shape(lambda rng: jb.init_forward(rng, batch),
                            jax.random.PRNGKey(0))
    return batch, draw_from_shapes(shapes, seed=seed)


def _twin_hparams(recipe, tmp, overrides):
    return load_hyperpyyaml(
        (TWIN / recipe / "hparams" / "train.yaml").read_text(),
        dict(overrides, data_folder=str(tmp / "data"),
             output_folder=str(tmp / "torch"), device="cpu"))


def _model_section(recipe, yaml="train.yaml"):
    text = (TWIN / recipe / "hparams" / yaml).read_text()
    return text[text.index("\nsample_rate:"):]


def test_timit_and_switchboard_build_commonvoices_model():
    """The TIMIT and Switchboard twin YAMLs hold CommonVoice's twin's text
    from the features on (as the JAX YAMLs hold the same values), so the
    weight-for-weight check of CommonVoice's covers them."""
    for recipe in (TIMIT, SWBD):
        assert _model_section(recipe) == _model_section(CV)


@pytest.mark.parametrize("recipe", [CV, SLURP])
def test_twin_yaml_builds_the_jax_recipes_weights(recipe, tmp_path):
    """At the JAX YAML's full width: the JAX recipe's parameter tree and
    running statistics load into the twin YAML's modules, every key used
    and every shape equal."""
    TWINS[recipe][0](tmp_path / "data")
    jb, raw, _ = _jax_recipe(recipe, tmp_path, {})
    _, variables = _variables(jb, raw)
    th = _twin_hparams(recipe, tmp_path, {})
    load_modules(th["modules"], variables)
    n = sum(p.numel() for m in th["modules"].values()
            for p in m.parameters())
    assert n == sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"]))


def _port_dataset(recipe, th, tok):
    if recipe == TIMIT:
        return timit_train.dataio_prepare(th, tok)
    if recipe == SLURP:
        return slurp_train.dataio_prepare(th, tok)
    return librispeech.dataio_prepare(th, tok)


@pytest.mark.parametrize("recipe", list(TWINS))
def test_first_loss_matches_the_jax_recipe(recipe, tmp_path):
    TWINS[recipe][0](tmp_path / "data")
    overrides = dict(TINY, output_neurons=24)
    if recipe != SLURP:
        overrides.update(TINY_LOCATION)
    jb, raw, tok = _jax_recipe(recipe, tmp_path, overrides)
    jbatch, variables = _variables(jb, raw)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = {k: jax.tree_util.tree_map(jnp.asarray, v)
             for k, v in variables.items() if k != "params"}
    jloss, _ = jax.jit(lambda p, s: jb._loss_and_aux(
        p, s, jbatch, JaxStage.TRAIN, jb.rng))(params, state)

    th = _twin_hparams(recipe, tmp_path, overrides)
    load_modules(th["modules"], variables)
    train = TWINS[recipe][1]
    brain_cls = slurp_train.SLU if recipe == SLURP else train.ASR
    pb = brain_cls(modules=th["modules"], hparams=th,
                   run_opts={"device": "cpu", "noprogressbar": True})
    pb.modules.train()
    data = _port_dataset(recipe, th, tok)
    batch = pb._prepare_batch(next(iter(pb.make_dataloader(
        data["train"], Stage.TRAIN, ckpt_prefix=None, batch_size=4,
        pad_to_multiple={"sig": _pad(recipe)}))))
    assert list(batch.id) == list(raw["id"])
    assert batch["sig"].data.shape[1] == jbatch["sig"][0].shape[1]
    ploss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                  batch, Stage.TRAIN)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)


# -- two twins as a user runs them ------------------------------------------

CLI = {
    "slurp": (SLURP, "speechbrain_tpu_torch.recipes.SLURP.direct.train",
              ["--rnn_layers=1", "--rnn_neurons=16", "--dnn_neurons=16",
               "--dec_neurons=16", "--attn_dim=16", "--emb_size=8",
               "--cnn_blocks=1"]),
    "timit": (TIMIT, "speechbrain_tpu_torch.recipes.TIMIT.ASR.seq2seq.train",
              ["--rnn_layers=1", "--rnn_neurons=16", "--dnn_blocks=1",
               "--dnn_neurons=16", "--dec_neurons=16", "--attn_dim=16",
               "--emb_size=8", "--cnn_blocks=1", "--location_kernel=11",
               "--output_neurons=24"]),
}
CLI_FLAGS = ["--debug", "--debug_batches=2", "--debug_epochs=1",
             "--batch_size=4", "--device=cpu", "--noprogressbar"]


@pytest.fixture(scope="module", autouse=True)
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recurrent_cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = {}
    for name, (recipe, module, flags) in CLI.items():
        cmd = [sys.executable, "-m", module,
               str(TWIN / recipe / "hparams" / "train.yaml"),
               f"--data_folder={tmp / name / 'data'}",
               f"--output_folder={tmp / name / 'out'}", *CLI_FLAGS, *flags]
        procs[name] = subprocess.Popen(
            cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    try:
        yield tmp, procs
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("name", list(CLI))
def test_the_twins_run_from_their_yamls(cli_runs, name):
    tmp, procs = cli_runs
    _, stderr = procs[name].communicate(timeout=600)
    assert procs[name].returncode == 0, stderr[-4000:]
    out = tmp / name / "out"
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert np.isfinite(losses).all()
    assert any((out / "save").glob("CKPT*"))


# -- chip_smoke's recurrent_twins_path on the CPU ----------------------------

def test_run_recurrent_twins_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's recurrent_twins_path end to end at a cut width: every
    phase's checks hold, B3 (its plain version, counted) runs once a
    batch (two steps and the valid batch) and once a served call."""
    lines = on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "SLU_SERVE", dict(
        clips=4, seconds=1.0, fill=(0.6, 0.98), max_decode_ratio=1.0,
        held_decode_ratio=0.2))
    launches = chip_smoke.run_recurrent_twins_path(str(tmp_path),
                                                   device="cpu")
    by_phase = {line["phase"]: line for line in lines}
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    assert launches == {"train_commonvoice": 3, "train_timit": 3,
                        "train_switchboard": 3, "train_slurp": 3,
                        "serve_slurp": 1}
    serve = by_phase["recurrent_twins/slurp"]["serve"]
    assert serve["utterances"] == 4 and len(serve["tokens"]) == 4
    assert 1 <= serve["search_steps"] <= serve["encoder_frames"]
