"""The enhancement twins against the JAX package's recipes
(``recipes/WHAMandWHAMR/enhancement``, ``DNS/enhancement``,
``VoiceBank/enhance/spectral_mask``, ``VoiceBank/enhance/waveform_map``,
``VoiceBank/dereverb/spectral_mask``, ``templates/enhancement``):

* each ``--debug`` corpus against JAX's, files and manifests byte for
  byte (the VoiceBank one against ``MetricGAN-U/train.py``'s, whose module
  the port cannot import);
* every one of the 24 twin YAMLs against its JAX YAML, read as text (the
  twin adds ``device``, the seed's draw and the checkpointer's epoch
  counter), and built on the CPU at its own width: the JAX model's
  variables, in flax's shapes, load into the twin's model, every key used;
* one CLI run a twin folder, in subprocesses started together, at a cut
  width under ``--debug``: a step, a valid batch, a checkpoint and an
  export that its interface serves;
* two optimizer steps of the spectral-mask twin's ``Brain.fit`` against
  the JAX recipe's from the same weights: float32 losses within 1e-4
  relative;
* the spectral-mask twin trains on ``sqrt(|STFT|^2 + 1e-8)`` where the
  interface masks ``log1p(sqrt(|STFT|^2 + 1e-14))``, in both packages: a
  policy difference kept, not repaired;
* ``chip_smoke.py``'s ``enhancement_path`` on the CPU at a cut width
  (``torch.cuda``'s timing calls stubbed): both chains served equal to
  the trained model, the ISTFT round trips, no kernel launched.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib
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
from speechbrain_tpu.utils.epoch_loop import EpochCounter as JaxEpochCounter
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.inference.enhancement import (
    SpectralMaskEnhancement,
    WaveformEnhancement,
)
from speechbrain_tpu_torch.inference.separation import SepformerSeparation
from speechbrain_tpu_torch.recipes.DNS.enhancement import (
    prepare as dns_prepare,
)
from speechbrain_tpu_torch.recipes.VoiceBank.dereverb.spectral_mask import (
    prepare as dereverb_prepare,
)
from speechbrain_tpu_torch.recipes.VoiceBank.enhance import (
    prepare as voicebank_prepare,
)
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask import (
    train as spectral_mask,
)
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_from_shapes
from test_torch_speaker_recipe import _Event

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speechbrain_tpu_torch"
LOSS_RTOL = 1e-4
# twin YAML (relative to the port's package) -> the JAX YAML (to the repo)
FOLDERS = ["recipes/WHAMandWHAMR/enhancement/hparams",
           "recipes/DNS/enhancement/hparams",
           "recipes/VoiceBank/enhance/spectral_mask/hparams",
           "recipes/VoiceBank/enhance/waveform_map/hparams",
           "recipes/VoiceBank/dereverb/spectral_mask/hparams",
           "templates/enhancement"]
YAMLS = sorted(str(p.relative_to(PORT)) for folder in FOLDERS
               for p in (PORT / folder).rglob("*.yaml"))


def _jax_path(yaml):
    return ROOT / yaml


def _load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text."""
    values = {}
    for line in Path(path).read_text().splitlines():
        m = re.match(r"^(\w+): ([^#\n]+?)\s*(#.*)?$", line)
        if m and not m.group(2).startswith(("!new:", "!include:")):
            values[m.group(1)] = m.group(2)
    return values


def _blocks(path):
    """Each top-level block with arguments: its tag line and indented
    lines, class paths read without their package's name."""
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    return {m.group(1): (m.group(2), m.group(3).splitlines())
            for m in re.finditer(r"^(\w+): (.*)\n((?:  .*\n)+)",
                                 text + "\n", re.M)}


def test_every_jax_yaml_of_the_six_folders_has_its_twin():
    """24 YAMLs: WHAM!/WHAMR!'s nine and four models, DNS's one, the
    VoiceBank spectral mask's one and four models, waveform map's and
    dereverberation's one and one model each, the template's one."""
    jax_yamls = sorted(str(p.relative_to(ROOT)) for folder in FOLDERS
                       for p in (ROOT / folder).rglob("*.yaml"))
    assert YAMLS == jax_yamls and len(YAMLS) == 24


# -- data preparation --------------------------------------------------------

PREPARES = {
    "voicebank": ("recipes/VoiceBank/enhance/MetricGAN-U/train.py",
                  "prepare_synthetic", voicebank_prepare.prepare_synthetic),
    "dereverb": ("recipes/VoiceBank/dereverb/spectral_mask/prepare.py",
                 "prepare_synthetic_reverb",
                 dereverb_prepare.prepare_synthetic_reverb),
    "dns": ("recipes/DNS/enhancement/prepare.py", "prepare_synthetic",
            dns_prepare.prepare_synthetic),
}


@pytest.mark.parametrize("corpus", list(PREPARES))
def test_prepare_synthetic_matches_jax(corpus, tmp_path):
    script, name, ours = PREPARES[corpus]
    theirs = getattr(_load_script(ROOT / script, f"jax_enh_{corpus}"), name)
    theirs(tmp_path / "jax")
    ours(tmp_path / "torch")
    for split in ("train.json", "valid.json"):
        j = json.loads((tmp_path / "jax" / split).read_text())
        t = json.loads((tmp_path / "torch" / split).read_text())
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
    """The JAX YAML's top-level scalars and each block's arguments are the
    twin's; the twin adds ``device`` (to the scalars and to every block
    that builds on a device or includes a model), the seed's draw, and
    the epoch counter among the checkpointer's recoverables."""
    jpath, tpath = _jax_path(yaml), PORT / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    if "seed" in j:
        assert t.pop("__set_seed").startswith("!apply:")
    assert t == j
    jb, tb = _blocks(jpath), _blocks(tpath)
    assert sorted(jb) == sorted(tb)
    for key, (jtag, jargs) in jb.items():
        ttag, targs = tb[key]
        assert ttag == jtag, key
        if key == "checkpointer":
            assert targs == jargs + ["  recoverables:",
                                     "    counter: !ref <epoch_counter>"]
        elif key in ("model", "compute_stft", "MaskNet"):
            assert targs == jargs + ["  device: !ref <device>"], key
        else:
            assert targs == jargs, key


# models that map a waveform; every other one masks (B, T, F) magnitudes
WAVEFORM_MODELS = ("WaveFCNMapper", "SepformerWrapper", "ConvTasNetWrapper")


def _model_input(jm, hparams):
    """A (1, ...) input of the JAX model: a waveform, or 8 frames of
    ``n_fft // 2 + 1`` magnitudes."""
    if type(jm).__name__ in WAVEFORM_MODELS:
        return jnp.zeros((1, 800))
    return jnp.zeros((1, 8, hparams.get("n_fft", 512) // 2 + 1))


# JAX models' variable shapes by the model's repr (its class and every
# argument): the WHAM!/WHAMR! and DNS SepFormers share one
_SHAPES = {}


def _variable_shapes(jm, x):
    key = (repr(jm), x.shape)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), x, train=False))
    return _SHAPES[key]


def _build(yaml, tmp_path):
    """The JAX YAML's and the twin YAML's objects (a models/ YAML with
    ``n_fft`` 512), the twin's on the CPU."""
    over = {} if "/models/" in yaml else {
        "data_folder": str(tmp_path), "output_folder": str(tmp_path / "o")}
    if "/models/" in yaml and "n_fft" in _scalars(PORT / yaml):
        over["n_fft"] = 512
    with open(_jax_path(yaml), encoding="utf-8") as f:
        jh = jax_load(f, over)
    th = load_hyperpyyaml((PORT / yaml).read_text(), dict(over, device="cpu"),
                          base_dir=(PORT / yaml).parent)
    return jh, th


def _model(hparams):
    if "model" in hparams:
        return hparams["model"]
    return hparams["modules"]["model"]


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_builds_the_jax_model(yaml, tmp_path):
    """At the YAML's own width: the JAX model's variables (zeros in
    flax's shapes, ``batch_stats`` included) load into the twin's model,
    every key and shape used, so the parameter counts are equal."""
    jh, th = _build(yaml, tmp_path)
    jm, tm = _model(jh), _model(th)
    shapes = _variable_shapes(jm, _model_input(jm, jh))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    load(tm, variables)
    n_jax = sum(np.prod(s.shape) for s in
                jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax > 0
    assert next(tm.parameters()).device.type == "cpu"


# -- the CLIs ----------------------------------------------------------------

# one YAML a folder and its cut width
CLI_RUNS = {
    "recipes.WHAMandWHAMR.enhancement": (
        "recipes/WHAMandWHAMR/enhancement/hparams/cnntransformer-whamr-DM.yaml",
        "--base_channels=32 --num_blocks=1 --nhead=2 --intermediate_size=16 "
        "--batch_size=2"),
    "recipes.DNS.enhancement": (
        "recipes/DNS/enhancement/hparams/sepformer-dns.yaml",
        "--encoder_out_nchannels=16 --masknet_chunksize=20 "
        "--dualpath_numlayers=1 --nhead=2 --d_ffn=32"),
    "recipes.VoiceBank.enhance.spectral_mask": (
        "recipes/VoiceBank/enhance/spectral_mask/hparams/train.yaml",
        "--base_channels=32 --num_blocks=1 --nhead=2 --intermediate_size=16"),
    "recipes.VoiceBank.enhance.waveform_map": (
        "recipes/VoiceBank/enhance/waveform_map/hparams/train.yaml",
        "--base_channels=8 --num_blocks=2 --kernel_size=5"),
    "recipes.VoiceBank.dereverb.spectral_mask": (
        "recipes/VoiceBank/dereverb/spectral_mask/hparams/train.yaml",
        "--hidden_size=8 --lin_size=8"),
    "templates.enhancement": ("templates/enhancement/train.yaml",
                              "--batch_size=2"),
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The six CLIs started together, one thread each; each one's
    completed process and output folder."""
    root = tmp_path_factory.mktemp("enhancement_twins")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = {}
    for module, (yaml, flags) in CLI_RUNS.items():
        work = root / module
        procs[module] = (subprocess.Popen(
            [sys.executable, "-m", f"speechbrain_tpu_torch.{module}.train",
             str(PORT / yaml), f"--data_folder={work / 'data'}",
             f"--output_folder={work / 'out'}", "--device=cpu", "--debug",
             "--debug_batches=1", "--debug_epochs=1", "--noprogressbar",
             *flags.split()],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), work / "out")
    results = {}
    for module, (proc, out) in procs.items():
        _, err = proc.communicate(timeout=300)
        results[module] = (proc.returncode, err, out)
    return results


@pytest.mark.parametrize("module", list(CLI_RUNS))
def test_twin_cli_runs_and_its_export_serves(cli_runs, module, tmp_path):
    rc, err, out = cli_runs[module]
    assert rc == 0, err[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"(?:loss|si-snr): ([0-9.e+-]+)",
                                           log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert len(list((out / "save").glob("CKPT*"))) == 1
    source = str(out / "pretrained")
    if module.endswith(("WHAMandWHAMR.enhancement", "spectral_mask",
                        "templates.enhancement")):
        interface = SpectralMaskEnhancement
    elif module.endswith("waveform_map"):
        interface = WaveformEnhancement
    else:
        interface = SepformerSeparation
    served = interface.from_hparams(source, savedir=str(tmp_path / "s"),
                                    run_opts={"device": "cpu"})
    noisy = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 4000)).astype(np.float32)) * 0.1
    out_wav = (served.separate_batch(noisy)[..., 0]
               if interface is SepformerSeparation
               else served.enhance_batch(noisy))
    assert out_wav.shape == noisy.shape
    assert torch.isfinite(out_wav).all()


# -- Brain.fit against the JAX recipe's --------------------------------------

SPECTRAL = "recipes/VoiceBank/enhance/spectral_mask/hparams/train.yaml"
SMALL = {"base_channels": 32, "num_blocks": 1, "nhead": 2,
         "intermediate_size": 16}


def test_spectral_mask_fit_matches_the_jax_recipe(tmp_path):
    """Two optimizer steps at batch 2 and the valid stage of the
    spectral-mask twin's ``Brain.fit`` against the JAX recipe's, from the
    same weights on the same corpus (6 utterances, the last 2 the valid
    split; the loaders pad to 2048 samples): every float32 train loss and
    the valid loss within 1e-4 relative."""
    voicebank_prepare.prepare_synthetic(tmp_path / "data", n_utts=6)
    over = dict(SMALL, data_folder=str(tmp_path / "data"))
    script = _load_script(ROOT / "recipes/VoiceBank/enhance/spectral_mask/"
                          "train.py", "jax_spectral_mask_train")
    with open(_jax_path(SPECTRAL), encoding="utf-8") as f:
        jh = jax_load(f, dict(over, output_folder=str(tmp_path / "jax")))
    _, th = spectral_mask.load_twin_yaml(
        str(PORT / SPECTRAL), dict(over, output_folder=str(tmp_path / "t"),
                                   device="cpu"))
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

    jb = recorded(script.EnhanceBrain, "jax")(
        modules=jh["modules"], hparams=jh, checkpointer=jh["checkpointer"],
        opt_class=lambda: optax.adam(jh["lr"]),
        run_opts={"noprogressbar": True})
    shapes = jax.eval_shape(lambda: jh["modules"]["model"].init(
        jax.random.PRNGKey(0), jnp.zeros((2, 70, 257)), train=False))
    variables = draw_from_shapes(shapes, seed=3)
    jb.params = {"model": jax.tree_util.tree_map(jnp.asarray,
                                                 variables["params"])}
    load(th["modules"]["model"], variables)
    pad = spectral_mask.PAD_TO_MULTIPLE
    loader = {"batch_size": 2, "pad_to_multiple": pad}
    jb.fit(JaxEpochCounter(1), *[script.dataio_prepare(jh)[s]
                                 for s in ("train", "valid")],
           train_loader_kwargs=loader, valid_loader_kwargs=loader)
    tb = recorded(spectral_mask.EnhanceBrain, "torch")(
        modules=th["modules"], hparams=th, checkpointer=th["checkpointer"],
        opt_class=lambda p: torch.optim.Adam(p, lr=th["lr"]),
        run_opts={"noprogressbar": True, "device": "cpu"})
    tb.fit(EpochCounter(1), *[spectral_mask.dataio_prepare(th)[s]
                              for s in ("train", "valid")],
           train_loader_kwargs=loader, valid_loader_kwargs=loader)
    assert len(losses["torch"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert valid["torch"] == pytest.approx(valid["jax"], rel=LOSS_RTOL)


def test_spectral_mask_trains_and_serves_on_other_features(tmp_path):
    """Policy difference (kept): the twin, as the JAX recipe, trains its
    masker on ``sqrt(|STFT|^2 + 1e-8)``; ``SpectralMaskEnhancement``, as
    JAX's, masks ``log1p(sqrt(|STFT|^2 + 1e-14))``. Each side equals its
    JAX counterpart, and the two differ."""
    from speechbrain_tpu.inference.enhancement import (
        SpectralMaskEnhancement as JaxSpectralMask,
    )
    from speechbrain_tpu.processing.features import STFT as JaxSTFT
    from speechbrain_tpu_torch.processing.features import STFT

    kw = dict(n_fft=512, win_length=32, hop_length=16)
    wav = 0.3 * np.random.default_rng(1).standard_normal(
        (2, 4000)).astype(np.float32)
    stft = STFT(16000, device="cpu", **kw)
    brain = spectral_mask.EnhanceBrain(
        modules={"model": torch.nn.Identity()},
        hparams={"compute_stft": stft}, run_opts={"device": "cpu"})
    trained_on = brain.spec_mag(torch.from_numpy(wav))
    served_on = SpectralMaskEnhancement(
        modules={"enhance_model": torch.nn.Identity()},
        hparams={"compute_stft": stft, "compute_istft": stft.inverse()},
        run_opts={"device": "cpu"}).compute_features(torch.from_numpy(wav))
    jstft = JaxSTFT(16000, backend="rfft", **kw)
    np.testing.assert_allclose(
        trained_on.numpy(), np.sqrt(np.asarray(jstft.power(wav)) + 1e-8),
        rtol=1e-5)
    jserved = JaxSpectralMask(
        modules={"enhance_model": None},
        hparams={"compute_stft": jstft, "compute_istft": jstft.inverse()}
    ).compute_features(jnp.asarray(wav))
    np.testing.assert_allclose(served_on.numpy(), np.asarray(jserved),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(trained_on.numpy(), served_on.numpy(), rtol=0.1)
    assert np.allclose(torch.log1p(trained_on).numpy(), served_on.numpy(),
                       atol=1e-3)


# -- chip_smoke's enhancement_path on the CPU --------------------------------

def test_run_enhancement_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's enhancement_path at a cut width on the CPU, with three
    of the other twins and one swapped masker: every phase's checks hold
    (both exports served equal to the same arithmetic on the trained
    module, the ISTFT round trips) and no kernel launches."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_WIDTHS", dict(
        SMALL, kernel_size=5, encoder_out_nchannels=16,
        masknet_chunksize=20, dualpath_numlayers=1, d_ffn=32, rnn_hidden=8,
        intra_numlayers=1, inter_numlayers=1, hidden_size=8, lin_size=8))
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_MASKER_WIDTHS", dict(
        base_channels=4, num_blocks=1, hidden_size=8, lin_size=8,
        kernel_size="!tuple (3, 3)"))
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_CORPUS",
                        dict(train=8, valid=4, seconds=0.5))
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_TWIN_SECONDS", 0.5)
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_SERVE",
                        dict(batch=2, seconds=0.5, repeats=1))
    twins = chip_smoke.ENHANCEMENT_TWINS
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_TWINS",
                        (twins[3], twins[-3], twins[-1]))
    monkeypatch.setattr(chip_smoke, "ENHANCEMENT_MASKERS",
                        ("2DFCN+BLSTM.yaml",))
    launches = chip_smoke.run_enhancement_path(str(tmp_path), device="cpu")
    assert launches == {name: 0 for name in chip_smoke.KERNELS}
    by_phase = {line["phase"]: line for line in lines
                if line["phase"] != "enhancement_reading"}
    assert len(by_phase) == 8
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    for chain in ("spectral_mask", "waveform_map"):
        line = by_phase[f"enhancement_path/{chain}"]
        assert line["forwards"] == {"TRAIN": 2, "VALID": 1}
        assert line["serve"]["served_equals_trained"]
        assert line["serve"]["out_shape"] == [2, 8000]
        assert len(line["serve"]["stoi_of_random_weights"]) == 2
    istft = by_phase["enhancement_path/istft_round_trip"]
    assert sorted(istft["cases"]) == ["16000Hz_nfft512_win512",
                                      "8000Hz_nfft512_win256"]
    # each twin's folder is removed after its step
    assert sorted(os.listdir(tmp_path)) == [
        "enhance_spectral_mask_train", "enhance_waveform_map_train"]
