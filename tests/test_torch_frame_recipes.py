"""The frame-level twins against the JAX package's recipes
(``recipes/LibriParty/VAD``, ``recipes/ZaionEmotionDataset/
emotion_diarization``, ``recipes/AMI/Diarization``), on the CPU:

* each twin's synthetic corpus against its JAX script's, files and
  manifests byte for byte;
* each of the four twin YAMLs against its JAX YAML, read as text (the
  twin adds ``device``, the seed's draw, the epoch counter among the
  checkpointer's recoverables, the input widths the port's constructors
  take, the export folder, and the AMI twins' fused ``Fbank``), and built
  on the CPU at its own width: the JAX modules' variables, in flax's
  shapes, load into the twin's, every key used;
* the VAD and ZED twins' first training loss on one batch of their corpus
  against the JAX recipes' ``compute_objectives`` over the JAX modules,
  the same weights carried across (a CRDNN of width 16, dropout 0; within
  1e-4 relative);
* one in-process CLI run a recipe folder under ``--debug``: the VAD and
  ZED exports served through ``VAD.from_hparams`` and
  ``Speech_Emotion_Diarization.from_hparams``; the AMI script with both
  YAMLs; and the AMI twin's windows, RTTM and DER against the JAX
  script's on the same weights (embeddings within 1e-4 relative, RTTM
  and DER equal);
* ``chip_smoke.py``'s ``frame_path`` on the CPU at a cut size
  (``torch.cuda``'s timing calls stubbed, B3's plain version counted as
  its launches), where every phase's checks but the VAD's frame accuracy
  hold (a few steps at a cut width do not train it that far).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import json
import logging
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from speechbrain_tpu.alignment import diarization as jdiar
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JaxCRDNN
from speechbrain_tpu.lobes.models.ECAPA_TDNN import ECAPA_TDNN as JaxECAPA
from speechbrain_tpu.lobes.models.Xvector import Xvector as JaxXvector
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.utils.DER import DER as jax_DER
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.batch import PaddedBatch
from speechbrain_tpu_torch.inference.diarization import (
    Speech_Emotion_Diarization,
)
from speechbrain_tpu_torch.inference.VAD import VAD
from speechbrain_tpu_torch.lobes.models.ECAPA_TDNN import ECAPA_TDNN
from speechbrain_tpu_torch.lobes.models.Xvector import Xvector
from speechbrain_tpu_torch.ops import mel_frontend, refuse_autograd
from speechbrain_tpu_torch.recipes.AMI.Diarization import (
    experiment as ami,
)
from speechbrain_tpu_torch.recipes.LibriParty.VAD import prepare as vad_prep
from speechbrain_tpu_torch.recipes.LibriParty.VAD import train as vad
from speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization import (  # noqa: E501
    prepare as zed_prep,
)
from speechbrain_tpu_torch.recipes.ZaionEmotionDataset.emotion_diarization import (  # noqa: E501
    train as zed,
)
from speechbrain_tpu_torch.utils.DER import DER
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_diarization import Jitted
from test_torch_rnn import draw_variables, japply
from test_torch_speaker_recipe import _Event

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speechbrain_tpu_torch"
LOSS_RTOL = 1e-4
EMB_RTOL = 1e-4
VAD_DIR = "recipes/LibriParty/VAD"
ZED_DIR = "recipes/ZaionEmotionDataset/emotion_diarization"
AMI_DIR = "recipes/AMI/Diarization"
YAMLS = [f"{VAD_DIR}/hparams/train.yaml", f"{ZED_DIR}/hparams/train.yaml",
         f"{AMI_DIR}/hparams/ecapa.yaml", f"{AMI_DIR}/hparams/xvectors.yaml"]
# the CRDNN at width 16 without dropout, in both packages' YAMLs
SMALL_CRDNN = [("rnn_neurons: 64", "rnn_neurons: 16"),
               ("dnn_neurons: 64", "dnn_neurons: 16"),
               ("input_size: 64", "input_size: 16"),
               ("dropout: 0.1", "dropout: 0.0")]


def _load_script(path):
    name = "jax_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_jax_yaml_of_the_three_folders_has_its_twin():
    jax_yamls = sorted(str(p.relative_to(ROOT)) for folder in (
        VAD_DIR, ZED_DIR, AMI_DIR) for p in (ROOT / folder).rglob("*.yaml"))
    assert sorted(YAMLS) == jax_yamls


# -- data preparation --------------------------------------------------------

PREPARES = {
    "libriparty": (f"{VAD_DIR}/prepare.py", vad_prep.prepare_synthetic,
                   ("train.json", "valid.json")),
    "zed": (f"{ZED_DIR}/prepare.py", zed_prep.prepare_synthetic,
            ("train.json", "valid.json")),
    "ami": (f"{AMI_DIR}/experiment.py", ami.prepare_synthetic,
            ("meetings.json",)),
}


@pytest.mark.parametrize("corpus", list(PREPARES))
def test_prepare_synthetic_matches_jax(corpus, tmp_path):
    script, ours, manifests = PREPARES[corpus]
    _load_script(script).prepare_synthetic(tmp_path / "jax")
    ours(tmp_path / "torch")
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for name in jfiles:
        j = (tmp_path / "jax" / name).read_bytes()
        t = (tmp_path / "torch" / name).read_bytes()
        if name in manifests:
            j, t = (x.decode().replace(str(tmp_path / d), "")
                    for x, d in ((j, "jax"), (t, "torch")))
        assert j == t, name


# -- the YAMLs ---------------------------------------------------------------

def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text, class paths
    without their package's name."""
    values = {}
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    for line in text.splitlines():
        m = re.match(r"^(\w+): ([^#\n]+?)\s*(#.*)?$", line)
        if m and not m.group(2).startswith("!new:"):
            values[m.group(1)] = m.group(2)
    return values


def _blocks(path):
    """Each top-level block: its tag and indented lines, comments dropped,
    class paths read without their package's name."""
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    return {m.group(1): (m.group(2), [
        line for line in m.group(3).splitlines()
        if not line.strip().startswith("#")])
        for m in re.finditer(r"^(\w+):( ?\S*)\n((?:  .*\n)*)", text + "\n",
                             re.M) if m.group(3)}


# argument lines a twin adds to a JAX block
ADDED_ARGS = (r"  device: !ref <device>", r"  input_size: !ref <n_mels>",
              r"  input_size: 64", r"  in_channels: !ref <n_mels>",
              r"  recoverables:", r"    counter: !ref <epoch_counter>")


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_values_are_the_jax_yamls(yaml):
    """The JAX YAML's top-level scalars and each block's tag and lines are
    the twin's; the twin adds ``device``, the seed's draw, the export
    folder of a training twin, the lines of ``ADDED_ARGS``, and, in the
    AMI YAMLs only, the fused ``Fbank``."""
    jpath, tpath = ROOT / yaml, PORT / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    assert t.pop("__set_seed").startswith("!apply:")
    ami_yaml = yaml.startswith(AMI_DIR)
    if not ami_yaml:
        assert t.pop("pretrained_folder") == "!ref <output_folder>/pretrained"
    j.pop("__set_seed", None)
    assert t == j
    jb, tb = _blocks(jpath), _blocks(tpath)
    assert sorted(jb) == sorted(tb)
    for key, (jtag, jargs) in jb.items():
        ttag, targs = tb[key]
        assert ttag == jtag, key
        assert targs[:len(jargs)] == jargs, key
        added = targs[len(jargs):]
        if ami_yaml and key == "compute_features":
            assert added[0] == "  fused: True"
            added = added[1:]
        for line in added:
            assert any(re.fullmatch(p, line) for p in ADDED_ARGS), (key, line)
    assert ("fused: True" in tpath.read_text()) == ami_yaml


def _jax_input(jm, tm):
    name = type(jm).__name__
    if name == "CRDNN":
        return (jnp.zeros((1, 32, 40)),), {"train": False}
    if name == "Linear":
        return (jnp.zeros((1, 8, tm.input_size)),), {}
    return (jnp.zeros((1, 32, 80)),), {"train": False}


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_builds_the_jax_models(yaml, tmp_path):
    """At the YAML's own width: each JAX module's variables (zeros in
    flax's shapes) load into the twin's, every key and shape used."""
    over = {"data_folder": str(tmp_path), "output_folder": str(tmp_path)}
    with open(ROOT / yaml, encoding="utf-8") as f:
        jh = jax_load(f, over)
    th = load_hyperpyyaml((PORT / yaml).read_text(), dict(over, device="cpu"))
    names = ["embedding_model"] if "embedding_model" in jh else ["model",
                                                                 "out_lin"]
    for name in names:
        jm, tm = jh[name], th[name]
        args, kwargs = _jax_input(jm, tm)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                                **kwargs))
        load(tm, jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        n_jax = sum(np.prod(s.shape) for s in
                    jax.tree_util.tree_leaves(shapes["params"]))
        assert sum(p.numel() for p in tm.parameters()) == n_jax > 0, name


# -- the first loss against the JAX recipes ----------------------------------

def _small_yaml(path, tmp_path, port):
    text = Path(path).read_text()
    for old, new in SMALL_CRDNN:
        text = text.replace(old, new)
    over = {"data_folder": str(tmp_path / "data"),
            "output_folder": str(tmp_path / "out")}
    if port:
        return load_hyperpyyaml(text, dict(over, device="cpu"))
    return jax_load(text, over)


@pytest.mark.parametrize("twin", ["vad", "zed"])
def test_first_loss_matches_the_jax_recipe(twin, tmp_path):
    """One batch of four of the twin's corpus in training mode (BatchNorm
    on the batch's statistics, dropout 0): the port's Brain against the
    JAX recipe's ``compute_objectives`` over the JAX modules applied to
    the same weights."""
    folder, module, prep = {"vad": (VAD_DIR, vad, vad_prep),
                            "zed": (ZED_DIR, zed, zed_prep)}[twin]
    prep.prepare_synthetic(tmp_path / "data")
    yaml = f"{folder}/hparams/train.yaml"
    jh = _small_yaml(ROOT / yaml, tmp_path, port=False)
    th = _small_yaml(PORT / yaml, tmp_path, port=True)
    prepare = vad.dataio_prepare if twin == "vad" else zed.prepare_emotions
    key = "speech_intervals" if twin == "vad" else "emotion_intervals"
    ds = prepare(th)["train"]
    batch = PaddedBatch([ds[i] for i in range(4)])
    wavs, lens = (x.numpy() for x in batch["sig"])
    intervals = batch[key].data.numpy()
    feats = jh["compute_features"](jnp.asarray(wavs))
    crdnn, lin = jh["model"], jh["out_lin"]
    cv = draw_variables(crdnn, feats, train=False)
    out, _ = japply(crdnn, cv, feats, train=True, mutable=["batch_stats"])
    lv = draw_variables(lin, out, seed=2)
    logits = lin.apply(lv, out)
    jscript = _load_script(f"{folder}/train.py")
    brain_cls = jscript.VADBrain if twin == "vad" else jscript.EmoDiarBrain
    jbatch = {"sig": (jnp.asarray(wavs), jnp.asarray(lens)),
              key: (jnp.asarray(intervals), jnp.asarray(lens))}
    jloss = brain_cls.compute_objectives(
        SimpleNamespace(hparams=SimpleNamespace(sample_rate=16000)),
        logits[..., 0] if twin == "vad" else logits, jbatch, None)
    load(th["model"], cv)
    load(th["out_lin"], lv)
    brain = (vad.VADBrain if twin == "vad" else zed.EmoDiarBrain)(
        modules=th["modules"], hparams=th, run_opts={"device": "cpu"})
    brain.modules.train()
    tloss = brain.compute_objectives(
        brain.compute_forward(batch, Stage.TRAIN), batch, Stage.TRAIN)
    assert tloss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)


# -- the CLIs, in process ----------------------------------------------------

def _main(main, argv):
    """A twin's ``main`` in this process; the log handler it adds to the
    root logger is taken off after."""
    handlers = list(logging.getLogger().handlers)
    try:
        return main(argv)
    finally:
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)


def _cli(folder, yaml, out, extra=()):
    return [str(PORT / folder / "hparams" / yaml),
            f"--data_folder={out / 'data'}", f"--output_folder={out / 'out'}",
            "--device=cpu", "--debug", *extra]


def test_vad_and_zed_clis_train_export_and_serve(tmp_path):
    """Each twin's CLI at its YAML's width, one batch: the export served
    through its interface's ``from_hparams`` (the fused Fbank's plain
    version on the CPU) on a file of the corpus."""
    steps = ["--debug_batches=1", "--debug_epochs=1", "--noprogressbar"]
    _main(vad.main, _cli(VAD_DIR, "train.yaml", tmp_path / "v", steps))
    served = VAD.from_hparams(source=tmp_path / "v" / "out" / "pretrained",
                              savedir=tmp_path / "v_served",
                              run_opts={"device": "cpu"})
    assert served.hparams.compute_features.fused
    wav = tmp_path / "v" / "data" / "party_0.wav"
    prob = served.get_speech_prob_file(str(wav))
    assert prob.shape == (1, 200, 1) and torch.isfinite(prob).all()
    assert served.get_speech_segments(str(wav)).shape[1] == 2
    _main(zed.main, _cli(ZED_DIR, "train.yaml", tmp_path / "z", steps))
    diarizer = Speech_Emotion_Diarization.from_hparams(
        source=tmp_path / "z" / "out" / "pretrained",
        savedir=tmp_path / "z_served", run_opts={"device": "cpu"})
    segs = diarizer.diarize_file(str(tmp_path / "z" / "data" / "zed_0.wav"))
    assert [s["start"] for s in segs] == [0.0, 0.5, 1.0]
    assert all(s["emotion"] in range(4) for s in segs)


AMI_SMALL = {
    "ecapa.yaml": (JaxECAPA, ECAPA_TDNN, dict(
        channels=(16, 16, 16, 16, 48), attention_channels=8,
        res2net_scale=4, se_channels=8, lin_neurons=12)),
    "xvectors.yaml": (JaxXvector, Xvector, dict(
        tdnn_channels=(16, 16, 16, 16, 30), lin_neurons=12)),
}


@pytest.mark.parametrize("yaml", list(AMI_SMALL))
def test_ami_twin_matches_the_jax_script(yaml, tmp_path):
    """The JAX script's windows and the twin's on its synthetic meeting,
    through a small embedder of the YAML's kind with the same weights:
    embeddings within 1e-4 relative; the same RTTM and DER from the same
    embeddings; then the twin's CLI at the YAML's full width."""
    jscript = _load_script(f"{AMI_DIR}/experiment.py")
    ami.prepare_synthetic(tmp_path / "data")
    meeting = json.loads((tmp_path / "data" / "meetings.json").read_text())
    rec = meeting["meeting"]
    sig = ami.read_audio(rec["wav"])
    jcls, tcls, kw = AMI_SMALL[yaml]
    jfbank = jfeatures.Fbank(n_mels=80)
    jm = jcls(**kw)
    variables = draw_variables(jm, jfbank(jnp.asarray(sig[None, :24000])),
                               train=False)
    tm = tcls(80, device="cpu", **kw).eval()
    load(tm, variables)
    with open(ROOT / AMI_DIR / "hparams" / yaml, encoding="utf-8") as f:
        jh = jax_load(f, {"data_folder": str(tmp_path)})
    jh.update(embedding_model=Jitted(jm), compute_features=jfbank)
    th = load_hyperpyyaml((PORT / AMI_DIR / "hparams" / yaml).read_text(),
                          {"data_folder": str(tmp_path), "device": "cpu"})
    jemb, jsegs = jscript.embed_windows(variables, jh, sig, 16000)
    temb, tsegs = ami.embed_windows(tm, th, torch.from_numpy(sig), 16000)
    assert tsegs == jsegs and len(tsegs) == 7
    assert np.linalg.norm(temb - jemb) <= EMB_RTOL * np.linalg.norm(jemb)
    # the clustering of 7 windows is ill-conditioned (2 neighbours a row
    # after pruning), so both sides cluster the same embeddings
    jlab = jdiar.do_spec_clustering(jemb, n_speakers=2, pval=jh["pval"],
                                    max_speakers=jh["max_speakers"])
    jout = jdiar.merge_ssegs_same_speaker(
        [(s[0], s[1], int(lab)) for s, lab in zip(jsegs, jlab)])
    tout = ami.cluster_windows(jemb, tsegs, th, "cpu")
    jdiar.write_rttm(jout, "meeting", tmp_path / "j.rttm")
    ami.write_rttm(tout, "meeting", tmp_path / "t.rttm")
    assert (tmp_path / "t.rttm").read_text() == \
        (tmp_path / "j.rttm").read_text()
    ref = [(x["start"], x["end"], x["spk"]) for x in rec["turns"]]
    assert DER(ref, [(s, e, str(lab)) for s, e, lab in tout]) == jax_DER(
        ref, [(s, e, str(lab)) for s, e, lab in jout])
    results = _main(ami.main, _cli(AMI_DIR, yaml, tmp_path / "cli"))
    assert results["meeting"]["windows"] == 7
    assert 0.0 <= results["meeting"]["der"] <= 1.0
    assert Path(results["meeting"]["rttm"]).read_text().startswith(
        "SPEAKER meeting 0 0.000")


# -- the card's path, on the CPU ----------------------------------------------

def test_run_frame_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's frame_path at a cut size on the CPU: every phase's
    checks hold (the VAD's frame accuracy taken at 0: a few steps at a
    raised rate), B3's plain version counted once for a file's chunks, a
    double-checked segment, a diarized segment and a window, as the path
    predicts, and no other kernel launches."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "FRAME_VAD_UTTS", 18)
    monkeypatch.setattr(chip_smoke, "FRAME_VAD_EPOCHS", 3)
    monkeypatch.setattr(chip_smoke, "FRAME_ACCURACY", 0.0)
    monkeypatch.setattr(chip_smoke, "FRAME_MEETING",
                        dict(chip_smoke.FRAME_MEETING, seconds=60.0))
    monkeypatch.setattr(chip_smoke, "FRAME_ZED_FILE",
                        dict(chip_smoke.FRAME_ZED_FILE, seconds=6.0))
    monkeypatch.setattr(chip_smoke, "FRAME_B3_SHAPES",
                        ((2, 16000, 40), (1, 24000, 80)))
    monkeypatch.setattr(chip_smoke, "FRAME_YAML_EDITS", [
        ("lr: 0.0003", "lr: 0.01"),
        ("channels: !tuple (256, 256, 256, 256, 768)",
         "channels: !tuple (16, 16, 16, 16, 48)"),
        ("tdnn_channels: [512, 512, 512, 512, 1500]",
         "tdnn_channels: [16, 16, 16, 16, 30]")])
    reference = mel_frontend.fused_fbank_reference

    def counted(wav, *args):
        # the kernel's stand-in: refuses a graph as the CUDA arm does
        refuse_autograd("fused_fbank_reference", wav)
        mel_frontend.launches += 1
        return reference(wav, *args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    handlers = list(logging.getLogger().handlers)
    try:
        launches, b3_err = chip_smoke.run_frame_path(str(tmp_path / "frame"),
                                                     device="cpu")
    finally:
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)
    by_phase = {line["phase"]: line for line in lines}
    assert list(by_phase) == [
        "frame_b3_check", "frame_path/vad",
        "frame_path/speaker_diarization", "frame_path/ami/ecapa.yaml",
        "frame_path/ami/xvectors.yaml", "frame_path/emotion_diarization",
        "frame_path_summary"]
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    summary = by_phase["frame_path_summary"]
    assert launches["fused_fbank"] == summary["predicted_b3"] > 0
    assert sum(launches.values()) == launches["fused_fbank"]
    ami_line = by_phase["frame_path/ami/ecapa.yaml"]
    # 60 s: (60 - 1.5) / 0.75 + 1 windows; the twin's own meeting: 7
    assert ami_line["windows"] == {"meeting": 7, "meeting300": 79}
    zed_line = by_phase["frame_path/emotion_diarization"]
    assert (zed_line["windows"], zed_line["jax_windows"]) == (11, 10)
    assert list(b3_err) == ["2x16000@40", "1x24000@80"]
