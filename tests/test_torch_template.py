"""The speech-recognition template's twin
(``speechbrain_tpu_torch/templates/speech_recognition``) against the JAX
template (``templates/speech_recognition/train.py``, imported as it is).

* Both from their own ``train.yaml`` at the same debug size (1 Conformer
  layer, d_model 32, 2 heads, d_ffn 64, 13 output classes: the blank and
  the corpus's 12 characters, batch 2, 2 epochs of 3 batches), dropout set
  to 0 in both files' encoder (``TransformerASR`` draws its dropout masks
  from each framework's own generator), the same initial weights (drawn
  from numpy in the JAX template's parameter tree, bridged into the
  twin's modules): the label file byte for byte, and each epoch's train
  and valid loss within 1e-4 relative (float32; the JAX template's
  ``Fbank`` and the twin's, both unfused, differ by about 1e-4 dB). The
  train loader shuffles in both, in one order (``test_torch_dataio.py``).
* The twin run as a user runs it, ``python -m ...train train.yaml
  --data_folder=... --device=cpu`` in a subprocess (started before the
  first test and waited for by the last): its checkpoint, its log, and its
  export, which ``EncoderASR.from_hparams`` serves with the best
  checkpoint's weights bit for bit."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.inference.ASR import EncoderASR
from speechbrain_tpu_torch.templates.speech_recognition import train as twin
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules

ROOT = Path(__file__).resolve().parent.parent
JAX_TEMPLATE = ROOT / "templates" / "speech_recognition"
TWIN = ROOT / "speechbrain_tpu_torch" / "templates" / "speech_recognition"
SR = 16000
WORDS = ["hi there", "go now", "stop it"]
OVERRIDES = {"num_layers": 1, "d_model": 32, "nhead": 2, "d_ffn": 64,
             "output_neurons": 13, "batch_size": 2, "number_of_epochs": 2}
LOSS_RTOL = 1e-4


def _write_corpus(data):
    """6 train, 2 valid and 2 test utterances of 0.3 s of noise, written
    as 16-bit PCM, with the JAX template test's words."""
    data.mkdir(parents=True, exist_ok=True)
    for split, n, base in (("train", 6, 0), ("valid", 2, 100),
                           ("test", 2, 200)):
        manifest = {}
        for i in range(n):
            uid = f"{split}_{i}"
            wav = data / f"{uid}.wav"
            sig = 0.1 * np.random.default_rng(base + i).standard_normal(
                int(0.3 * SR))
            with wave.open(str(wav), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(SR)
                f.writeframes((sig * 32767).astype(np.int16).tobytes())
            manifest[uid] = {"wav": str(wav), "words": WORDS[i % 3],
                             "length": 0.3}
        (data / f"{split}.json").write_text(json.dumps(manifest))
    return data


@pytest.fixture(scope="module", autouse=True)
def twin_cli(tmp_path_factory):
    """The twin's ``train.py`` in a subprocess, as a user runs it."""
    tmp = tmp_path_factory.mktemp("template_cli")
    data = _write_corpus(tmp / "data")
    flags = [f"--{k}={v}" for k, v in OVERRIDES.items()]
    cmd = ([sys.executable, "-m",
            "speechbrain_tpu_torch.templates.speech_recognition.train",
            str(TWIN / "train.yaml"), f"--data_folder={data}",
            f"--output_folder={tmp}/out", "--device=cpu",
            "--noprogressbar"] + flags)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        yield tmp, proc
    finally:
        proc.kill()
        proc.communicate()


def _finished(twin_cli):
    tmp, proc = twin_cli
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-4000:]
    return tmp


def _yaml_without_dropout(path):
    text = path.read_text()
    anchor = "  encoder_module: conformer\n"
    assert text.count(anchor) == 1
    return text.replace(anchor, anchor + "  dropout: 0.0\n")


def _jax_template():
    spec = importlib.util.spec_from_file_location(
        "jax_speech_recognition_template", JAX_TEMPLATE / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _random_params(shapes, seed=0):
    """Weights from a numpy seed in the template's tree: kernels scaled by
    1/sqrt(fan-in), layer-norm scales about 1, biases about 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "kernel":
            return x / np.sqrt(int(np.prod(leaf.shape[:-1])))
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _recording(cls, losses):
    class Recorded(cls):
        def on_stage_end(self, stage, stage_loss, epoch=None):
            if stage.name == "VALID":
                losses.append((float(self.train_loss), float(stage_loss)))
            super().on_stage_end(stage, stage_loss, epoch)
    return Recorded


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("template")
    data = _write_corpus(tmp / "data")
    overrides = dict(OVERRIDES, data_folder=str(data))

    jax_losses = []
    template = _jax_template()
    jh = jax_load(_yaml_without_dropout(JAX_TEMPLATE / "train.yaml"),
                  dict(overrides, output_folder=str(tmp / "jax")))
    os.makedirs(jh["save_folder"], exist_ok=True)
    jdatasets = template.dataio_prep(jh)
    loader = {"batch_size": jh["batch_size"],
              "pad_to_multiple": {"sig": twin.SIG_PAD_MULTIPLE}}
    jb = _recording(template.ASRBrain, jax_losses)(
        modules=jh["modules"], opt_class=lambda: optax.adam(jh["lr"]),
        hparams=jh, run_opts={"noprogressbar": True},
        checkpointer=jh["checkpointer"])
    first = jb._prepare_batch(next(iter(jax_make_dataloader(
        jdatasets["train"], **loader))))
    init = _random_params(jax.eval_shape(
        lambda rng: jb.init_forward(rng, first), jax.random.PRNGKey(0)
    )["params"])
    jb.params = jax.tree_util.tree_map(jax.numpy.asarray, init)
    jb.fit(jh["epoch_counter"], jdatasets["train"], jdatasets["valid"],
           train_loader_kwargs=dict(loader, shuffle=True),
           valid_loader_kwargs=loader)

    port_losses = []
    th = load_hyperpyyaml(_yaml_without_dropout(TWIN / "train.yaml"),
                          dict(overrides, output_folder=str(tmp / "torch"),
                               device="cpu"))
    load_modules(th["modules"], jax.tree_util.tree_map(np.asarray, init))
    brain = twin.run(th, {"device": "cpu", "noprogressbar": True},
                     brain_cls=_recording(twin.ASRBrain, port_losses))
    return {"jax": jax_losses, "torch": port_losses, "jh": jh, "th": th,
            "brain": brain}


def test_label_files_equal(runs):
    names = [Path(h["save_folder"]) / "label_encoder.txt"
             for h in (runs["jh"], runs["th"])]
    assert names[0].read_bytes() == names[1].read_bytes()
    assert len(runs["th"]["label_encoder"]) == OVERRIDES["output_neurons"]


def test_per_epoch_losses_match_the_jax_template(runs):
    assert len(runs["torch"]) == len(runs["jax"]) == 2
    np.testing.assert_allclose(np.array(runs["torch"]),
                               np.array(runs["jax"]), rtol=LOSS_RTOL)
    assert runs["brain"].optimizer_step == 6
    # the losses fell: the run trained
    assert runs["torch"][1][0] < runs["torch"][0][0]


def test_export_serves_the_best_checkpoint(runs):
    """``export`` after ``fit``: the pretrained folder holds the best
    checkpoint's files and a hyperparams.yaml that
    ``EncoderASR.from_hparams`` loads on the CPU."""
    th = runs["th"]
    best = th["checkpointer"].find_checkpoint(min_key="loss")
    folder = Path(th["pretrained_folder"])
    for name in ("encoder", "ctc_head", "label_encoder"):
        assert (folder / f"{name}.ckpt").read_bytes() == \
            (best.path / f"{name}.ckpt").read_bytes(), name
    asr = EncoderASR.from_hparams(str(folder), savedir=folder.parent / "s",
                                  run_opts={"device": "cpu"})
    saved = torch.load(best.path / "encoder.ckpt", weights_only=True)
    served = asr.hparams.asr_model.state_dict()
    assert saved.keys() == served.keys()
    assert all(torch.equal(saved[k], served[k]) for k in saved)
    assert asr.tokenizer.lab2ind == th["label_encoder"].lab2ind


def test_the_twin_runs_from_its_yaml_and_its_export_serves(twin_cli):
    tmp = _finished(twin_cli)
    out = tmp / "out"
    log = (out / "train_log.txt").read_text().splitlines()
    assert len(log) == 2 and log[1].startswith("epoch: 2")
    assert all("valid loss" in line for line in log)
    ckpts = list((out / "save").glob("CKPT+*"))
    assert len(ckpts) == 1
    assert {p.name for p in ckpts[0].iterdir()} >= {
        "CKPT.yaml", "encoder.ckpt", "ctc_head.ckpt", "label_encoder.ckpt",
        "counter.ckpt", "modules.ckpt", "optimizer.ckpt", "brain.ckpt"}
    asr = EncoderASR.from_hparams(str(out / "pretrained"),
                                  savedir=tmp / "served",
                                  run_opts={"device": "cpu"})
    words = asr.transcribe_file(tmp / "data" / "test_0.wav")
    assert isinstance(words, str)
    assert set(words) <= set(asr.tokenizer.lab2ind) - {0}
    batch_words, hyps = asr.transcribe_batch(
        torch.zeros(2, SR // 2), torch.tensor([1.0, 0.5]))
    assert len(batch_words) == 2 and all(
        0 < t < OVERRIDES["output_neurons"] for h in hyps for t in h)
