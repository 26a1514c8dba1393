"""The streaming LibriSpeech Conformer transducer twin
(``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transducer``,
``conformer_transducer_streaming.yaml``) against the JAX recipe
(``recipes/LibriSpeech/ASR/transducer/train.py``, imported as it is): the
float32 loss of one batch at dropout 0 under a fixed chunk configuration;
the twin run from its YAML at the debug flags of
``tests/recipes/recipes.csv:113``; ``chip_smoke.py``'s ``streaming_path``
configuration against the twin YAML; and ``run_streaming_path`` itself on
the CPU at a small size (``torch.cuda``'s timing calls stubbed, the fused
Fbank's plain version counted as its launches).

Weights, batches and the tolerance (the loss 1e-4 relative) are those of
``test_torch_transducer_recipe.py``."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.utils.dynamic_chunk_training import (
    DynChunkTrainConfig as JaxConfig,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.ops import mel_frontend
from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
    DynChunkTrainConfig,
)
from test_torch_seq2seq_recipe import _scalars
from test_torch_transducer_recipe import LOSS_RTOL, RECIPE, TWIN, setup  # noqa: F401

YAML = TWIN / "hparams" / "conformer_transducer_streaming.yaml"
JAX_YAML = RECIPE / "hparams" / "conformer_transducer_streaming.yaml"
# a chunk configuration that splits the test batch's encoder frames
CHUNK, LEFT = 8, 1


def test_the_streaming_twins_loss_matches_the_jax_recipe(setup):  # noqa: F811
    jb, jbatch, variables, pb, batch = setup
    jb.hparams.streaming = pb.hparams.streaming = True
    jb.hparams.dynchunktrain_config_sampler = lambda stage: JaxConfig(
        CHUNK, LEFT)
    pb.hparams.dynchunktrain_config_sampler = lambda stage: (
        DynChunkTrainConfig(CHUNK, LEFT))
    try:
        jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jloss, _ = jax.jit(lambda p: jb._loss_and_aux(
            p, {}, jbatch, JaxStage.TRAIN, jb.rng))(jparams)
        pb.modules.train()
        ploss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                      batch, Stage.TRAIN)
        pb.hparams.streaming = False
        full = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                     batch, Stage.TRAIN)
    finally:
        jb.hparams.streaming = pb.hparams.streaming = False
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)
    # the chunks change the loss
    assert abs(float(ploss.detach()) - float(full.detach())) > 1e-3


# tests/recipes/recipes.csv:113, the streaming LibriSpeech transducer row
FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=2 "
         "--vocab_size=32 --d_model=32 --nhead=4 --d_ffn=64 "
         "--num_encoder_layers=2 --joint_dim=32 --dec_neurons=32 "
         "--emb_size=16").split()


def test_the_streaming_twin_runs_from_its_yaml(tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(TWIN.parents[4]))
    proc = subprocess.run(
        [sys.executable, "-m",
         "speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train",
         str(YAML), f"--data_folder={tmp_path / 'data'}",
         f"--output_folder={out}", "--device=cpu", "--noprogressbar",
         *FLAGS],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any((out / "save").glob("CKPT*"))


def test_streaming_path_configuration_is_the_yaml():
    twin = _scalars(YAML)
    jax_yaml = _scalars(JAX_YAML)
    assert jax_yaml == {k: v for k, v in twin.items() if k != "device"}
    assert twin["streaming"] == "True"
    text = YAML.read_text()
    block = text[text.index("dynchunktrain_config_sampler:"):]
    values = dict(re.findall(r"^  (\w+): ([0-9.]+)$", block, re.M))
    assert {k: float(v) for k, v in values.items()} == {
        k: float(v) for k, v in chip_smoke.STREAMING_SAMPLER.items()}
    for name in ("valid_config", "test_config"):
        sub = block[block.index(name):]
        assert int(re.search(r"chunk_size: (\d+)", sub)[1]) == \
            chip_smoke.STREAMING_CONFIG["chunk_size"]
        assert int(re.search(r"left_context_size: (\d+)", sub)[1]) == \
            chip_smoke.STREAMING_CONFIG["left_context_size"]
    assert "strides: !tuple (2, 2)" in text
    assert chip_smoke.STREAMING_FRONTEND_STRIDE == 2 * 2
    assert "fused: True" in text
    # the model is transducer_path's: the same values as the sibling YAML
    sibling = _scalars(TWIN / "hparams" / "conformer_transducer.yaml")
    assert {k: v for k, v in twin.items() if k in sibling} == sibling
    # the forced step's configuration lies in the sampler's range
    forced = chip_smoke.STREAMING_FORCED
    assert forced["chunk_size"] == chip_smoke.STREAMING_SAMPLER[
        "chunk_size_min"]
    assert forced["left_context_size"] == chip_smoke.STREAMING_SAMPLER[
        "left_context_chunks_min"]


class _Event:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


SMALL = dict(chip_smoke.TRANSDUCER_CFG, n_mels=16, fe_channels=(4, 8),
             d_model=32, nhead=4, d_ffn=64, enc_layers=2, kernel_size=7,
             joint_dim=16, dec_neurons=16, emb_size=8, vocab=40,
             batch_size=4)
SMALL_TRAIN = dict(chip_smoke.TRAIN, n_train=8, n_valid=4,
                   seconds=(0.5, 0.9), n_tokens=(3, 6))


def test_run_streaming_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's streaming path end to end at a small size: every check
    of its serve, training and TIMIT phases holds, and B3 (its plain
    version, counted) runs once a chunk and once a batch."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "NORTH",
                        dict(chip_smoke.NORTH, batch=2, seconds=1.5))
    monkeypatch.setattr(chip_smoke, "STREAMING_CMP_FRAMES", 20)
    reference = mel_frontend.fused_fbank_reference
    arm = mel_frontend._fused_fbank_cuda

    def counted(*args):
        # the kernel's stand-in: counted unless plain_versions swapped it
        if mel_frontend._fused_fbank_cuda is arm:
            mel_frontend.launches += 1
        return reference(*args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    paths = chip_smoke.write_asr_corpus(SMALL_TRAIN, str(tmp_path))
    launches, shape, file_shape = chip_smoke.run_streaming_path(
        str(tmp_path / "streaming"), paths, cfg=SMALL, device="cpu")
    by_phase = {line.get("phase"): line for line in lines}
    serve = by_phase["streaming_serve"]
    assert serve["ok"], serve["checks"]
    assert by_phase["streaming_train"]["ok"]
    assert by_phase["streaming_path/timit_transducer"]["ok"]
    # 1.5 s: two chunks of 0.96 s, the second padded
    assert serve["chunks"] == 2 and launches["bf16_stream"] == 2
    assert launches["file_stream"] == 2
    assert serve["encoder_frames_a_chunk"] == 24
    assert shape == (2, 15360 + 640) and file_shape == (1, 16000)
    train = by_phase["streaming_train"]
    assert len(train["sampler_draws"]) == 2 + train["forwards"]["VALID"]
    assert train["forced_draw"] == [["TRAIN", [8, 2]]]
