"""The GAN and MTL twins against the JAX package's recipes
(``recipes/VoiceBank/enhance/{SEGAN,MetricGAN,MetricGAN-U}``,
``VoiceBank/enhancement``, ``VoiceBank/dereverb/MetricGAN-U``,
``VoiceBank/MTL/ASR_enhance``, ``RescueSpeech/ASR/noise-robust``):

* each twin's ``--debug`` corpus against its JAX script's, files and
  manifests byte for byte;
* each of the 14 twin YAMLs against its JAX YAML, read as text (the twin
  adds ``device``, the seed's draw, the epoch counter among the
  checkpointer's recoverables, the input widths the port's constructors
  take, and the fused ``Fbank`` of the perceptual pre-training), and built
  on the CPU at its own width: the JAX modules' variables, in flax's
  shapes, load into the twin's, every key used;
* one in-process CLI run a twin folder at a cut width under ``--debug``;
  the MetricGAN twin resumed from its checkpoint, both optimizers
  restored; MetricGAN-U's DNSMOS YAML raising without a scorer;
* MetricGAN's first D and G losses and STOI against the JAX recipe's from
  the same weights on the same batch, within 1e-4 relative (C50 enters
  only after the first G step);
* ``chip_smoke.py``'s ``gan_path`` on the CPU at a cut width
  (``torch.cuda``'s timing calls stubbed, B3's plain version counted as
  its launches and refusing a graph as the kernel's wrapper does).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib
import importlib.util
import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.dataio.batch import PaddedBatch
from speechbrain_tpu_torch.dataio.dataio import read_audio
from speechbrain_tpu_torch.ops import mel_frontend, refuse_autograd
from speechbrain_tpu_torch.recipes.VoiceBank.enhance import prepare
from speechbrain_tpu_torch.recipes.VoiceBank.enhance.MetricGAN import (
    train as metricgan,
)
from speechbrain_tpu_torch.recipes.VoiceBank.MTL.ASR_enhance import (
    train as mtl,
)
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import draw_from_shapes
from test_torch_speaker_recipe import _Event

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speechbrain_tpu_torch"
LOSS_RTOL = 1e-4
METRICGAN_YAML = "recipes/VoiceBank/enhance/MetricGAN/hparams/train.yaml"
FOLDERS = ["recipes/VoiceBank/enhance/SEGAN",
           "recipes/VoiceBank/enhance/MetricGAN",
           "recipes/VoiceBank/enhance/MetricGAN-U",
           "recipes/VoiceBank/enhancement",
           "recipes/VoiceBank/dereverb/MetricGAN-U",
           "recipes/VoiceBank/MTL/ASR_enhance",
           "recipes/RescueSpeech/ASR/noise-robust"]
YAMLS = sorted(str(p.relative_to(PORT)) for folder in FOLDERS
               for p in (PORT / folder).rglob("*.yaml"))


def _twin(folder):
    """A twin folder's ``train`` module (two folders are named with a
    hyphen)."""
    return importlib.import_module(
        "speechbrain_tpu_torch." + folder.replace("/", ".") + ".train")


def _load_script(path):
    name = "jax_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_jax_yaml_of_the_seven_folders_has_its_twin():
    """14 YAMLs: SEGAN's, MetricGAN's, MetricGAN-U's two, the
    band-correlation MetricGAN's, the dereverberation MetricGAN-U's, the
    MTL twin's three stages and four models, RescueSpeech's."""
    jax_yamls = sorted(str(p.relative_to(ROOT)) for folder in FOLDERS
                       for p in (ROOT / folder).rglob("*.yaml"))
    assert YAMLS == jax_yamls and len(YAMLS) == 14


# -- data preparation --------------------------------------------------------

PREPARES = {
    "segan": ("recipes/VoiceBank/enhance/SEGAN/train.py",
              lambda d: prepare.prepare_synthetic(d, modulated=False)),
    "metricgan": ("recipes/VoiceBank/enhance/MetricGAN/train.py",
                  prepare.prepare_synthetic),
    "metricgan_u": ("recipes/VoiceBank/enhance/MetricGAN-U/train.py",
                    prepare.prepare_synthetic),
    "enhancement": ("recipes/VoiceBank/enhancement/train.py",
                    lambda d: prepare.prepare_synthetic(d, modulated=False)),
    "dereverb": ("recipes/VoiceBank/dereverb/MetricGAN-U/train.py",
                 lambda d: prepare.prepare_synthetic(d, reverb=True)),
    "mtl": ("recipes/VoiceBank/MTL/ASR_enhance/train.py",
            mtl.prepare_synthetic),
    "rescuespeech": ("recipes/RescueSpeech/ASR/noise-robust/train.py",
                     lambda d: _twin(FOLDERS[-1]).prepare_corpus(
                         {"data_folder": d})),
}


@pytest.mark.parametrize("corpus", list(PREPARES))
def test_prepare_synthetic_matches_jax(corpus, tmp_path):
    script, ours = PREPARES[corpus]
    _load_script(script).prepare_synthetic(tmp_path / "jax")
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

def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text, class paths
    without their package's name."""
    values = {}
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    for line in text.splitlines():
        m = re.match(r"^(\w+): ([^#\n]+?)\s*(#.*)?$", line)
        if m and not m.group(2).startswith(("!new:", "!include:")):
            values[m.group(1)] = m.group(2)
    return values


def _blocks(path):
    """Each top-level object: its tag and its indented argument lines
    (comments dropped), class paths read without their package's name."""
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    return {m.group(1): (m.group(2), [
        line for line in m.group(3).splitlines()
        if not line.strip().startswith("#")])
        for m in re.finditer(r"^(\w+): (!(?:new|include):\S*)\n((?:  .*\n)*)",
                             text + "\n", re.M)}


# argument lines a twin adds to a JAX block: the device, the input widths
# flax infers, the epoch counter among the checkpointer's recoverables
ADDED_ARGS = (r"  device: !ref <device>", r"  n_freq: !ref <n_fft> // 2 \+ 1",
              r"  in_channels: 1", r"  input_size: !ref <\w+(\[\w+\])?>",
              r"  n_fft: !ref <n_fft>", r"  n_mels: !ref <n_mels>",
              r"  recoverables:", r"    counter: !ref <epoch_counter>")


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_values_are_the_jax_yamls(yaml):
    """The JAX YAML's top-level scalars and each object's tag and
    arguments are the twin's; the twin adds ``device``, the seed's draw,
    the widths its model YAMLs leave to the including file
    (``!PLACEHOLDER``) and the lines of ``ADDED_ARGS``; only the
    perceptual pre-training asks for the fused ``Fbank``."""
    jpath, tpath = ROOT / yaml, PORT / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    if "seed" in j and "__set_seed" not in j:
        assert t.pop("__set_seed").startswith("!apply:")
    for key in ("n_fft", "n_mels"):
        if key in t and key not in j:
            assert t.pop(key) == "!PLACEHOLDER"
    assert t == j
    jb, tb = _blocks(jpath), _blocks(tpath)
    assert sorted(jb) == sorted(tb)
    for key, (jtag, jargs) in jb.items():
        ttag, targs = tb[key]
        assert ttag == jtag, key
        assert targs[:len(jargs)] == jargs, key
        added = targs[len(jargs):]
        if yaml.endswith("pretrain_perceptual.yaml") and \
                key == "compute_features":
            assert added[0] == "  fused: True"
            added = added[1:]
        for line in added:
            assert any(re.fullmatch(p, line) for p in ADDED_ARGS), (key, line)
    assert ("fused: True" in tpath.read_text()) == yaml.endswith(
        "pretrain_perceptual.yaml")


def _jax_input(jm, tm):
    """``(args, kwargs)`` of the JAX module's ``init``: a (1, ...) input
    of the width the twin's module takes."""
    name = type(jm).__name__
    z = jnp.zeros
    if name in ("EnhancementGenerator", "FCN2DBLSTMMasker"):
        return (z((1, 8, 257)),), {"train": False}
    if name == "MetricDiscriminator":
        return (z((1, 8, 257, tm.bn_in.input_size)),), {"train": False}
    if name == "Generator":
        key = jax.random.PRNGKey(0)
        return (z((1, 1024)),), {"rngs": {"params": key, "noise": key}}
    if name == "Discriminator":
        return (z((1, 1024, 2)),), {"train": False}
    if name == "CRDNN":
        return (z((1, 32, 40)),), {"train": False}
    if name == "Linear":
        return (z((1, 8, tm.input_size)),), {}
    if name == "TransformerASR":
        return (z((1, 16, 40)),), {"method": "encode"}
    raise KeyError(name)


def _build(yaml, tmp_path):
    """The JAX YAML's and the twin YAML's objects (a models/ YAML with
    ``n_fft`` 512 and ``n_mels`` 40), the twin's on the CPU."""
    if "/models/" in yaml:
        over = {}
        tover = {k: v for k, v in (("n_fft", 512), ("n_mels", 40))
                 if k in _scalars(PORT / yaml)}
    else:
        over = {"data_folder": str(tmp_path),
                "output_folder": str(tmp_path / "o")}
        tover = dict(over)
    with open(ROOT / yaml, encoding="utf-8") as f:
        jh = jax_load(f, over)
    th = load_hyperpyyaml((PORT / yaml).read_text(), dict(tover, device="cpu"),
                          base_dir=(PORT / yaml).parent)
    return jh, th


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_builds_the_jax_models(yaml, tmp_path):
    """At the YAML's own width: each JAX module's variables (zeros in
    flax's shapes, ``batch_stats`` included) load into the twin's, every
    key and shape used, so the parameter counts are equal."""
    jh, th = _build(yaml, tmp_path)
    pairs = ({"model": (jh["model"], th["model"])} if "model" in jh else
             {k: (jh["modules"][k], th["modules"][k])
              for k in jh["modules"]})
    assert "model" in jh or sorted(jh["modules"]) == sorted(th["modules"])
    for name, (jm, tm) in pairs.items():
        args, kwargs = _jax_input(jm, tm)
        shapes = jax.eval_shape(lambda: jm.init(
            kwargs.pop("rngs", jax.random.PRNGKey(0)), *args, **kwargs))
        variables = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
        load(tm, variables)
        n_jax = sum(np.prod(s.shape) for s in
                    jax.tree_util.tree_leaves(shapes["params"]))
        assert sum(p.numel() for p in tm.parameters()) == n_jax > 0, name
        assert next(tm.parameters()).device.type == "cpu"


# -- the CLIs, in process ----------------------------------------------------

SMALL_GEN = "--lstm_neurons=8 --dnn_neurons=8"
CLI_RUNS = {
    "recipes/VoiceBank/enhance/SEGAN": (
        "train.yaml", "--kernel_size=8 --segment_size=1024"),
    "recipes/VoiceBank/enhance/MetricGAN": ("train.yaml", SMALL_GEN),
    "recipes/VoiceBank/enhance/MetricGAN-U": ("train.yaml", SMALL_GEN),
    "recipes/VoiceBank/enhancement": ("train.yaml", SMALL_GEN),
    "recipes/VoiceBank/dereverb/MetricGAN-U": ("train_dereverb.yaml",
                                               SMALL_GEN),
    "recipes/VoiceBank/MTL/ASR_enhance": (
        "robust_asr.yaml", SMALL_GEN + " --batch_size=2"),
    "recipes/RescueSpeech/ASR/noise-robust": (
        "train.yaml", SMALL_GEN + " --batch_size=2 --d_model=16 --nhead=2 "
        "--num_layers=1 --d_ffn=16"),
}
GAN_FOLDERS = FOLDERS[:5]


def _main(folder, yaml, out, flags, extra=()):
    """The twin's ``main`` in this process under ``--debug``; the log
    handler it adds to the root logger is taken off after."""
    argv = [str(PORT / folder / "hparams" / yaml),
            f"--data_folder={out / 'data'}", f"--output_folder={out / 'out'}",
            "--device=cpu", "--debug", "--debug_batches=1",
            "--debug_epochs=1", "--noprogressbar", *flags.split(), *extra]
    handlers = list(logging.getLogger().handlers)
    try:
        return _twin(folder).main(argv)
    finally:
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)
                h.close()


@pytest.mark.parametrize("folder", list(CLI_RUNS))
def test_twin_cli_runs_a_step(folder, tmp_path):
    """One batch and one epoch: the log's losses finite, one checkpoint;
    a GAN twin's checkpoint holds both optimizers."""
    yaml, flags = CLI_RUNS[folder]
    brain = _main(folder, yaml, tmp_path, flags)
    out = tmp_path / "out"
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and losses and all(np.isfinite(losses))
    ckpts = list((out / "save").glob("CKPT*"))
    assert len(ckpts) == 1
    saved = sorted(p.name for p in ckpts[0].glob("*.ckpt"))
    if folder in GAN_FOLDERS:
        assert {"optimizer_generator.ckpt",
                "optimizer_discriminator.ckpt"} <= set(saved)
        assert sorted(brain.optimizers_dict) == ["discriminator",
                                                 "generator"]
    else:
        assert "optimizer.ckpt" in saved


def test_metricgan_resumes_both_optimizers(tmp_path):
    """A second run in the same folder recovers the first's checkpoint:
    the epoch counter, both modules and both optimizers (each Adam's step
    count goes on from 1 to 2), then trains epoch 2."""
    folder = "recipes/VoiceBank/enhance/MetricGAN"
    _main(folder, "train.yaml", tmp_path, SMALL_GEN)
    brain = _main(folder, "train.yaml", tmp_path, SMALL_GEN,
                  ("--number_of_epochs=2", "--debug_epochs=2"))
    log = (tmp_path / "out" / "train_log.txt").read_text()
    assert "epoch: 1" in log and "epoch: 2" in log
    for name, opt in brain.optimizers_dict.items():
        steps = {float(s["step"]) for s in opt.state.values()}
        assert steps == {2.0}, name


def test_dnsmos_yaml_raises_without_a_scorer(tmp_path):
    """``train_dnsmos.yaml``'s ``dnsmos_fn: null`` raises before any step,
    as the JAX script does; a local scorer runs in its place (``gan_path``
    runs it with the port's SRMR)."""
    with pytest.raises(RuntimeError, match="dnsmos_fn"):
        _main("recipes/VoiceBank/enhance/MetricGAN-U", "train_dnsmos.yaml",
              tmp_path, SMALL_GEN)


# -- MetricGAN's first step against the JAX recipe ---------------------------

def test_metricgan_first_losses_match_the_jax_recipe(tmp_path):
    """One batch of two debug utterances through the JAX recipe's loop
    body (``spec_mag``, the eval-mode enhancement, ``resynth``, the host
    STOI target, its ``make_gan_steps``) and the twin's ``gan_batch``,
    from the same drawn weights: the D loss, the G loss and the STOI within
    ``LOSS_RTOL``. JAX's single Adam and the twin's two agree up to here:
    the first D step leaves the generator as it was in both."""
    script = _load_script("recipes/VoiceBank/enhance/MetricGAN/train.py")
    prepare.prepare_synthetic(tmp_path / "data", n_utts=4)
    over = {"data_folder": str(tmp_path / "data"), "lstm_neurons": 8,
            "dnn_neurons": 8}
    with open(ROOT / METRICGAN_YAML, encoding="utf-8") as f:
        jh = jax_load(f, dict(over, output_folder=str(tmp_path / "j")))
    th = load_hyperpyyaml((PORT / METRICGAN_YAML).read_text(),
                          dict(over, output_folder=str(tmp_path / "t"),
                               device="cpu"))
    manifest = json.loads((tmp_path / "data" / "train.json").read_text())
    items = [manifest[k] for k in ("u0", "u1")]
    noisy = np.stack([np.asarray(read_audio(i["noisy_wav"])) for i in items])
    clean = np.stack([np.asarray(read_audio(i["clean_wav"])) for i in items])
    lens = np.ones(2, np.float32)

    jb = script.MetricGanBrain(
        modules=jh["modules"], hparams=jh,
        opt_class=lambda: optax.adam(jh["lr"]),
        run_opts={"noprogressbar": True})
    noisy_mag = jb.spec_mag(jnp.asarray(noisy))
    clean_mag = jb.spec_mag(jnp.asarray(clean))
    vg = draw_from_shapes(jax.eval_shape(lambda: jh["generator"].init(
        jax.random.PRNGKey(0), noisy_mag, train=False)), seed=21)
    vd = draw_from_shapes(jax.eval_shape(lambda: jh["discriminator"].init(
        jax.random.PRNGKey(0), jnp.stack([noisy_mag, clean_mag], -1),
        train=False)), seed=22)
    jb.params = {"generator": vg["params"], "discriminator": vd["params"]}
    jb.params = jax.tree_util.tree_map(jnp.asarray, jb.params)
    jb.model_state = {"batch_stats": {"discriminator": jax.tree_util.tree_map(
        jnp.asarray, vd["batch_stats"])}}
    jb.init_optimizers()
    d_step, g_step = jb.make_gan_steps(jb.d_loss_fn, jb.g_loss_fn,
                                       "discriminator", "generator")
    k = jax.random.PRNGKey(jh["seed"])
    est_mag = jb.enhance_mag(jb.params, noisy_mag, False, None)
    est_wav = np.asarray(jb.resynth(est_mag, jnp.asarray(noisy)))
    sl = script.stoi_loss(est_wav, clean, lens, reduction="batch")
    target = jnp.asarray(-np.asarray(sl), jnp.float32)
    params, state, opt_state, d_l = d_step(
        jb.params, jb.model_state, jb.opt_state,
        (est_mag, clean_mag, target), k)
    _, _, _, g_l = g_step(params, state, opt_state, (noisy_mag, clean_mag),
                          k)

    load(th["modules"]["generator"], vg)
    load(th["modules"]["discriminator"], vd)
    tb = metricgan.MetricGanBrain(
        modules=th["modules"], hparams=th, opt_class=metricgan.adam_groups(
            th["lr"]), run_opts={"device": "cpu"})
    tb.d_step, tb.g_step = tb.make_gan_steps(
        tb.d_loss_fn, tb.g_loss_fn, "discriminator", "generator")
    tb.modules.train()
    batch = PaddedBatch([
        {"id": f"u{i}", "noisy_sig": torch.from_numpy(noisy[i]),
         "clean_sig": torch.from_numpy(clean[i])} for i in range(2)])
    got = tb.gan_batch(0, batch)
    assert got["stoi_loss"] == pytest.approx(float(np.mean(sl)),
                                             rel=LOSS_RTOL)
    assert got["d_loss"] == pytest.approx(float(d_l), rel=LOSS_RTOL)
    assert got["g_loss"] == pytest.approx(float(g_l), rel=LOSS_RTOL)


# -- chip_smoke's gan_path on the CPU ----------------------------------------

def test_run_gan_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's gan_path at a cut width on the CPU: every phase's checks
    hold (MetricGAN+ served equal to the trained module, restored bit for
    bit, the step semantics; SEGAN; the MTL chain with B3's plain version
    counted once a batch and the fused Fbank refused under robust ASR's
    gradient; the other six twins), and no other kernel launches."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "GAN_WIDTHS", dict(
        lstm_neurons=8, dnn_neurons=8, kernel_size=8, segment_size=2048,
        d_model=16, nhead=2, num_layers=1, d_ffn=16, batch_size=2))
    monkeypatch.setattr(chip_smoke, "GAN_SECONDS", 0.5)
    monkeypatch.setattr(chip_smoke, "GAN_SEGAN_SECONDS", 0.2)
    monkeypatch.setattr(chip_smoke, "GAN_SERVE",
                        dict(batch=2, seconds=0.5, repeats=1))
    monkeypatch.setattr(chip_smoke, "GAN_B3_SHAPES", ((2, 8192, 40),))
    reference = mel_frontend.fused_fbank_reference

    def counted(wav, *args):
        # the kernel's stand-in: refuses a graph as the CUDA arm does
        refuse_autograd("fused_fbank_reference", wav)
        mel_frontend.launches += 1
        return reference(wav, *args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    launches, b3_launches, b3_err = chip_smoke.run_gan_path(
        str(tmp_path / "gan"), device="cpu")
    by_phase = {line["phase"]: line for line in lines}
    assert len(by_phase) == 13
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    main = by_phase["gan_path/metricgan"]
    assert main["serve"]["served_equals_trained"] and main["restored_bitwise"]
    assert main["step_semantics"]["ok"] and len(main["stoi_ms"]) == 3
    # 2 train and 2 valid batches of 2
    assert b3_launches == {"pretrain_perceptual": 4, "robust_asr": 0}
    assert launches == {"ancestry_attention": 0, "fused_fbank": 4,
                        "flash_attention": 0, "row_gather": 0}
    assert by_phase["gan_path/mtl/robust_asr_with_fused_fbank"]["raised"]
    assert list(b3_err) == ["2x8192@40"]
