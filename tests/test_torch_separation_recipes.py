"""The separation twins against the JAX package's recipes
(``recipes/WSJ0Mix/separation``, ``LibriMix/separation``,
``WHAMandWHAMR/separation``, ``Aishell1Mix/separation``,
``BinauralWSJ0Mix/separation``), each imported as it is:

* ``prepare_synthetic`` against JAX's, files and manifests byte for byte;
* every twin YAML's values against the JAX YAML's, read as text (the
  twin adds ``device`` and the checkpointer's recoverables, C44, and two
  take their own output folder, C45), and the JAX recipe's parameter tree
  of each model family loading into the twin YAML's model at a cut width;
* each of the 21 twin YAMLs run by its CLI's ``main`` on the CPU at a cut
  width under ``--debug``: one optimizer step and one valid batch, a
  finite loss, a checkpoint and its export;
* three optimizer steps of the WSJ0Mix SepFormer twin's ``Brain.fit``
  against the JAX recipe's, the same weights and crops: float32 losses
  step by step within 1e-4 relative, the valid loss and the rate the
  scheduler set;
* ``chip_smoke.py``'s ``separation_path`` on the CPU at a cut width
  (``torch.cuda``'s timing calls stubbed): the chain, its export served
  by ``SepformerSeparation.from_hparams`` in both compositions equal to
  the trained model, no kernel launched.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.utils.epoch_loop import EpochCounter as JaxEpochCounter
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.recipes.Aishell1Mix.separation import (
    prepare as aishell_prepare,
)
from speechbrain_tpu_torch.recipes.BinauralWSJ0Mix.separation import (
    train as binaural_train,
)
from speechbrain_tpu_torch.recipes.LibriMix.separation import (
    prepare as librimix_prepare,
)
from speechbrain_tpu_torch.recipes.WHAMandWHAMR.separation import (
    prepare as wham_prepare,
)
from speechbrain_tpu_torch.recipes.WSJ0Mix.separation import (
    train as wsj0mix_train,
)
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_from_shapes
from test_torch_speaker_recipe import _Event

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "recipes"
TWIN = ROOT / "speechbrain_tpu_torch" / "recipes"
LOSS_RTOL = 1e-4
YAMLS = sorted(str(p.relative_to(TWIN))
               for p in TWIN.glob("*/separation/hparams/*.yaml"))
# the cut width, given to each YAML that names the key
SMALL = {"encoder_out_nchannels": 16, "masknet_chunksize": 20,
         "intra_numlayers": 1, "inter_numlayers": 1, "dualpath_numlayers": 1,
         "n_layers": 2, "nhead": 2, "d_ffn": 32, "rnn_hidden": 8,
         "training_signal_len": 4000, "enc_N": 8, "mask_B": 4, "mask_H": 8,
         "mask_X": 2, "mask_R": 1}
# the twins whose JAX YAML writes into Libri2Mix's output folder (C45)
OWN_OUTPUT = {"WHAMandWHAMR/separation/hparams/sepformer-whamr.yaml",
              "BinauralWSJ0Mix/separation/hparams/sepformer-binaural.yaml"}


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _keys(path):
    return {m.group(1) for m in re.finditer(r"^(\w+):", Path(path)
                                            .read_text(), re.M)}


def _small(path):
    keys = _keys(path)
    return {k: v for k, v in SMALL.items() if k in keys}


def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text."""
    values = {}
    for line in Path(path).read_text().splitlines():
        m = re.match(r"^(\w+): ([^#\n]+?)\s*(#.*)?$", line)
        if m and not m.group(2).startswith("!new:"):
            values[m.group(1)] = m.group(2)
    return values


def _block(path, key):
    """The indented lines of a top-level ``key:`` block, class paths read
    without their package's name."""
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    m = re.search(rf"^{key}: (.*)\n((?:  .*\n)*)", text + "\n", re.M)
    return m.group(1), m.group(2).splitlines()


# -- data preparation --------------------------------------------------------

PREPARES = {
    "LibriMix": (JAX / "LibriMix/separation/prepare.py",
                 librimix_prepare.prepare_synthetic, {"num_spks": 3}),
    "WHAMandWHAMR": (JAX / "WHAMandWHAMR/separation/prepare.py",
                     wham_prepare.prepare_synthetic, {}),
    "Aishell1Mix": (JAX / "Aishell1Mix/separation/prepare.py",
                    aishell_prepare.prepare_synthetic,
                    {"num_spks": 3, "wham_noise": True}),
    "BinauralWSJ0Mix": (JAX / "BinauralWSJ0Mix/separation/train.py",
                        binaural_train.prepare_synthetic,
                        {"noise": True, "reverb": True}),
}


@pytest.mark.parametrize("recipe", list(PREPARES))
def test_prepare_synthetic_matches_jax(recipe, tmp_path):
    script, ours, kwargs = PREPARES[recipe]
    _load_script(script, f"jax_sep_prepare_{recipe}").prepare_synthetic(
        tmp_path / "jax", **kwargs)
    ours(tmp_path / "torch", **kwargs)
    for name in ("train.json", "valid.json"):
        j = json.loads((tmp_path / "jax" / name).read_text())
        t = json.loads((tmp_path / "torch" / name).read_text())
        assert list(j) == list(t) and len(j) >= 2
        for key in j:
            assert sorted(j[key]) == sorted(t[key])
            for field, value in j[key].items():
                if not field.endswith("_wav"):
                    assert t[key][field] == value
                    continue
                assert Path(value).name == Path(t[key][field]).name
                assert Path(value).read_bytes() == \
                    Path(t[key][field]).read_bytes()


# -- the YAMLs ---------------------------------------------------------------

@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_values_are_the_jax_yamls(yaml):
    """The JAX YAML's top-level scalars and its model's arguments are the
    twin's; the twin adds ``device``, and its checkpointer keeps the epoch
    counter (and the scheduler where there is one)."""
    jpath, tpath = JAX / yaml, TWIN / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    assert t.pop("__set_seed").startswith("!apply:")
    if yaml in OWN_OUTPUT:
        shared = "!ref results/sepformer_libri2mix/<seed>"
        assert j.pop("output_folder") == shared != t.pop("output_folder")
    assert t == j
    jcls, jargs = _block(jpath, "model")
    tcls, targs = _block(tpath, "model")
    assert tcls == jcls and targs == jargs + ["  device: !ref <device>"]
    _, recoverables = _block(tpath, "checkpointer")
    assert "    counter: !ref <epoch_counter>" in recoverables
    assert ("lr_scheduler" in _keys(jpath)) == \
        ("    lr_scheduler: !ref <lr_scheduler>" in recoverables)


def test_jax_yamls_lose_the_schedule_and_share_an_output_folder(tmp_path):
    """C44: the JAX separation YAMLs' checkpointers name no recoverables,
    so a resumed run starts its epochs and ``ReduceLROnPlateau`` anew; the
    twins' keep both. C45: two JAX YAMLs write into Libri2Mix's output
    folder, where each would recover the other's checkpoint."""
    for yaml in YAMLS:
        _, block = _block(JAX / yaml, "checkpointer")
        assert block == ["  checkpoints_dir: !ref <save_folder>"], yaml
    outputs = {}
    for yaml in YAMLS:
        outputs.setdefault(_scalars(JAX / yaml)["output_folder"],
                           []).append(yaml)
    shared = outputs["!ref results/sepformer_libri2mix/<seed>"]
    assert set(shared) == OWN_OUTPUT | {
        "LibriMix/separation/hparams/sepformer-libri2mix.yaml"}
    assert len({_scalars(TWIN / y)["output_folder"] for y in YAMLS}) == \
        len(YAMLS)
    # the twin's checkpointer brings the scheduler's state back
    path = TWIN / "WSJ0Mix/separation/hparams/sepformer.yaml"
    over = dict(_small(path), data_folder=str(tmp_path),
                output_folder=str(tmp_path / "out"), device="cpu")
    h = load_hyperpyyaml(path.read_text(), over)
    h["lr_scheduler"](1.0, 70, 3.0)
    h["checkpointer"].save_checkpoint(meta={"loss": 3.0})
    again = load_hyperpyyaml(path.read_text(), over)
    again["checkpointer"].recover_if_possible()
    assert again["lr_scheduler"].anchor == 3.0
    assert again["lr_scheduler"].losses == [3.0]
    jh = jax_load((JAX / "WSJ0Mix/separation/hparams/sepformer.yaml")
                  .read_text(), {"data_folder": str(tmp_path),
                                 "output_folder": str(tmp_path / "jax")})
    assert "lr_scheduler" not in jh["checkpointer"].recoverables


# one YAML a model family: the JAX recipe's tree loads into the twin's
FAMILIES = ["WSJ0Mix/separation/hparams/sepformer.yaml",
            "WSJ0Mix/separation/hparams/sepformer-conformerintra.yaml",
            "WSJ0Mix/separation/hparams/dprnn.yaml",
            "WSJ0Mix/separation/hparams/resepformer.yaml",
            "WSJ0Mix/separation/hparams/skim.yaml",
            "WSJ0Mix/separation/hparams/convtasnet.yaml",
            "BinauralWSJ0Mix/separation/hparams/convtasnet-cross.yaml",
            "BinauralWSJ0Mix/separation/hparams/convtasnet-parallel.yaml"]


@pytest.mark.parametrize("yaml", FAMILIES)
def test_twin_yaml_builds_the_jax_recipes_weights(yaml, tmp_path):
    """At the cut width: a draw in the shapes of the JAX YAML's model's
    variables loads into the twin YAML's model, every key used and every
    shape equal."""
    over = dict(_small(TWIN / yaml), data_folder=str(tmp_path),
                output_folder=str(tmp_path / "out"))
    jh = jax_load((JAX / yaml).read_text(), over)
    th = load_hyperpyyaml((TWIN / yaml).read_text(), dict(over,
                                                          device="cpu"))
    stereo = "stereo_model" in _keys(JAX / yaml)
    mix = jnp.zeros((1, 1000, 2) if stereo else (1, 1000))
    variables = draw_from_shapes(jax.eval_shape(
        lambda: jh["model"].init(jax.random.PRNGKey(0), mix, train=False)))
    load(th["model"], variables)
    n = sum(p.numel() for p in th["model"].parameters())
    assert n == sum(np.asarray(v).size for v in
                    jax.tree_util.tree_leaves(variables["params"]))


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_cli_takes_a_step_on_the_cpu(yaml, tmp_path):
    """The twin's CLI ``main`` under ``--debug`` at the cut width: its
    synthetic corpus, one optimizer step, one valid batch, a finite loss,
    a checkpoint and the export ``SepformerSeparation`` reads."""
    corpus = yaml.split("/")[0]
    module = importlib.import_module(
        f"speechbrain_tpu_torch.recipes.{corpus}.separation.train")
    args = [str(TWIN / yaml), f"--data_folder={tmp_path / 'data'}",
            f"--output_folder={tmp_path / 'out'}", "--device=cpu",
            "--debug", "--debug_batches=1", "--debug_epochs=1",
            "--noprogressbar"]
    args += [f"--{k}={v}" for k, v in _small(TWIN / yaml).items()]
    brain = module.main(args)
    assert brain.optimizer_step == 1 and np.isfinite(brain.train_loss)
    assert len(brain.checkpointer.list_checkpoints()) == 1
    log = (tmp_path / "out" / "train_log.txt").read_text()
    assert "epoch: 1" in log
    assert {p.name for p in (tmp_path / "out" / "pretrained").iterdir()} \
        == {"hyperparams.yaml", "masknet.ckpt"}


# -- Brain.fit against the JAX recipe's --------------------------------------

def test_wsj0mix_fit_matches_the_jax_recipe(tmp_path):
    """Three optimizer steps of batch 2 (random 4000-sample crops from one
    seeded generator on each side) and the valid stage of the WSJ0Mix
    SepFormer twin's ``Brain.fit`` against the JAX recipe's, from the
    same weights: every float32 train loss and the valid loss within 1e-4
    relative, the rate ``ReduceLROnPlateau`` set equal."""
    yaml = "WSJ0Mix/separation/hparams/sepformer.yaml"
    librimix_prepare.prepare_synthetic(tmp_path / "data")
    over = dict(_small(TWIN / yaml), data_folder=str(tmp_path / "data"),
                train_annotation=str(tmp_path / "data" / "train.json"),
                valid_annotation=str(tmp_path / "data" / "valid.json"))
    script = _load_script(JAX / "WSJ0Mix/separation/train.py",
                          "jax_wsj0mix_separation_train")
    jh = jax_load((JAX / yaml).read_text(),
                  dict(over, output_folder=str(tmp_path / "jax")))
    th = load_hyperpyyaml((TWIN / yaml).read_text(), dict(
        over, output_folder=str(tmp_path / "torch"), device="cpu"))
    for h in (jh, th):
        Path(h["save_folder"]).mkdir(parents=True)
    losses = {"jax": [], "torch": []}
    valid = {}

    def recorded(cls, side):
        class Recorded(cls):
            def on_fit_batch_end(self, batch, outputs, loss, should_step):
                losses[side].append(float(loss))
                super().on_fit_batch_end(batch, outputs, loss, should_step)

            def on_stage_end(self, stage, stage_loss, epoch=None):
                if stage.name == "VALID":
                    valid[side] = float(stage_loss)
                super().on_stage_end(stage, stage_loss, epoch)
        return Recorded

    jb = recorded(script.Separation, "jax")(
        modules=jh["modules"], hparams=jh, checkpointer=jh["checkpointer"],
        opt_class=lambda: optax.inject_hyperparams(optax.adam)(
            learning_rate=jh["lr"]),
        run_opts={"noprogressbar": True})
    shapes = jax.eval_shape(lambda: jh["model"].init(
        jax.random.PRNGKey(0), jnp.zeros((2, 4000)), train=False))
    variables = draw_from_shapes(shapes, seed=3)
    jb.params = {"model": jax.tree_util.tree_map(jnp.asarray,
                                                 variables["params"])}
    load(th["model"], variables)
    loader = {"batch_size": 2}
    jb.fit(JaxEpochCounter(1), *[script.dataio_prepare(jh)[s]
                                 for s in ("train", "valid")],
           train_loader_kwargs=loader, valid_loader_kwargs=loader)
    tb = recorded(wsj0mix_train.Separation, "torch")(
        modules=th["modules"], hparams=th, checkpointer=th["checkpointer"],
        opt_class=lambda p: torch.optim.Adam(p, lr=th["lr"]),
        run_opts={"noprogressbar": True, "device": "cpu"})
    tb.fit(EpochCounter(1), *[wsj0mix_train.dataio_prepare(th)[s]
                              for s in ("train", "valid")],
           train_loader_kwargs=loader, valid_loader_kwargs=loader)
    assert len(losses["torch"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert valid["torch"] == pytest.approx(valid["jax"], rel=LOSS_RTOL)
    assert tb.optimizer.param_groups[0]["lr"] == th["lr"]
    assert th["lr_scheduler"].losses == pytest.approx(
        jh["lr_scheduler"].losses, rel=LOSS_RTOL)


# -- chip_smoke's separation_path on the CPU ---------------------------------

def test_run_separation_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's separation_path at a cut width on the CPU, with three
    of the other twins: every phase's checks hold (the export served in
    both compositions equal to the trained model, the PIT loss unchanged
    by a swap of the targets) and no kernel launches."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    small = {k: v for k, v in SMALL.items() if k != "training_signal_len"}
    monkeypatch.setattr(chip_smoke, "SEPARATION_WIDTHS", small)
    monkeypatch.setattr(chip_smoke, "SEPARATION_CORPUS",
                        dict(train=2, valid=1, seconds=0.6))
    monkeypatch.setattr(chip_smoke, "SEPARATION_TWIN_CORPUS",
                        dict(train=1, valid=1, seconds=0.5))
    monkeypatch.setattr(chip_smoke, "SEPARATION_SERVE",
                        dict(batch=2, seconds=0.5, repeats=1))
    monkeypatch.setattr(chip_smoke, "SEPARATION_TWINS", (
        ("WSJ0Mix", "skim.yaml"), ("LibriMix", "sepformer-libri3mix.yaml"),
        ("BinauralWSJ0Mix", "convtasnet-cross.yaml")))
    launches = chip_smoke.run_separation_path(str(tmp_path), device="cpu")
    assert launches == {name: 0 for name in chip_smoke.KERNELS}
    readings = [line for line in lines
                if line["phase"] == "separation_reading"]
    assert [sorted(r)[1] for r in readings] == [
        "served_audio_s_per_s", "sepformer_second_step_ms",
        "sepformer_peak_gb"]
    by_phase = {line["phase"]: line for line in lines
                if line["phase"] != "separation_reading"}
    assert len(by_phase) == 5
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    main = by_phase["separation_path/wsj0mix_sepformer"]
    assert main["forwards"] == {"TRAIN": 2, "VALID": 1}
    assert main["checks"]["est_shape"] == [2, 4000, 2]
    assert main["checks"]["served_equals_trained"] == {
        "full_wrapper": True, "three_modules": True}
    assert main["serve"]["three_modules"]["modules"] == [
        "decoder", "encoder", "masknet"]
    assert main["checks"]["pit_swap_bitwise"]
    # 0.6 s mixtures are shorter than the YAML's 4 s crops: whole signals
    assert main["train_audio_seconds"] == pytest.approx(2 * 0.6)
