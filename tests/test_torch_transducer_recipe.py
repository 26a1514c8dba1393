"""The LibriSpeech Conformer transducer twin
(``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/transducer``) against the
JAX recipe (``recipes/LibriSpeech/ASR/transducer/train.py``, imported as
it is): the float32 loss of one batch (transducer + 0.3 CTC) at dropout
0, and the twin's greedy ``transcribe_batch`` against the JAX searcher
over the same modules; the twin run from its YAML at the debug flags of
``tests/recipes/recipes.csv``; the streaming configuration's step; and
``chip_smoke.py``'s ``transducer_path`` configuration against the twin
YAML's values.

Weights come from a numpy seed in the JAX recipe's variables (shapes from
``jax.eval_shape`` of its ``init_forward``). The JAX features come from
its unfused ``Fbank``, the port's from the fused one (on the CPU its plain
version). Tolerance: the loss 1e-4 relative; tokens equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
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

import chip_smoke
from speechbrain_tpu.core import Stage as JaxStage
from speechbrain_tpu.dataio.dataio import read_audio as jax_read_audio
from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.decoders.transducer import (
    TransducerBeamSearcher as JaxSearcher,
)
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxTransformerASR,
)
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.RNN import LSTM as JaxLSTM
from speechbrain_tpu.nnet.transducer_joint import TransducerJoint as JaxJoint
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.RNN import LSTM
from speechbrain_tpu_torch.nnet.schedulers import NewBobScheduler
from speechbrain_tpu_torch.nnet.transducer_joint import TransducerJoint
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer import train
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_rnn import draw_from_shapes
from test_torch_seq2seq_recipe import _scalars

ROOT = Path(__file__).resolve().parents[1]
RECIPE = ROOT / "recipes" / "LibriSpeech" / "ASR" / "transducer"
TWIN = ROOT / "speechbrain_tpu_torch" / "recipes" / "LibriSpeech" / "ASR" \
    / "transducer"
LOSS_RTOL = 1e-4
V, N_MELS, J, D = 11, 16, 16, 32
CFG = dict(vocab=V, n_train=4, n_valid=2, seconds=(0.4, 0.5),
           n_tokens=(3, 5), bos=0, eos=0)
LOADER = {"batch_size": 2, "pad_to_multiple": {"sig": 16000}}


def _recipe():
    spec = importlib.util.spec_from_file_location(
        "librispeech_transducer_train", RECIPE / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fold(text):
    return [1 + int(t) % (V - 1) for t in text.split()]


def _jax_dataset(manifest):
    ds = JaxDataset.from_json(manifest).filtered_sorted(sort_key="length")
    ds.add_dynamic_item(jax_read_audio, takes="wav", provides="sig")
    ds.add_dynamic_item(lambda text: np.asarray(_fold(text), np.int32),
                        takes="tokens", provides="tokens_ids")
    ds.set_output_keys({"id": "id", "sig": "sig", "tokens": "tokens_ids"})
    return ds


def _hparams(fbank, norm):
    return {"compute_features": fbank, "normalize": norm, "ctc_weight": 0.3,
            "blank_index": 0}


def _jax_brain():
    modules = {
        "frontend": JaxFrontEnd(num_blocks=2, out_channels=(4, 8),
                                kernel_sizes=(3, 3), strides=(2, 2),
                                dropout=0.0),
        "encoder": JaxTransformerASR(
            tgt_vocab=V, input_size=32, d_model=D, nhead=4,
            num_encoder_layers=1, num_decoder_layers=0, d_ffn=64,
            dropout=0.0, encoder_module="conformer", kernel_size=7),
        "enc_proj": JaxLinear(n_neurons=J),
        "emb": JaxEmbedding(num_embeddings=V, embedding_dim=8),
        "dec": JaxLSTM(hidden_size=12),
        "dec_proj": JaxLinear(n_neurons=J),
        "joint": JaxJoint(joint_dim=J, joint="sum"),
        "out": JaxLinear(n_neurons=V),
        "ctc_head": JaxLinear(n_neurons=V),
    }
    return _recipe().TransducerASR(
        modules=modules,
        hparams=_hparams(JaxFbank(n_mels=N_MELS),
                         JaxNorm(norm_type="sentence")),
        run_opts={"noprogressbar": True})


def port_modules(device="cpu"):
    kw = dict(device=device)
    return {
        "frontend": ConvolutionFrontEnd(num_blocks=2, out_channels=(4, 8),
                                        kernel_sizes=(3, 3), strides=(2, 2),
                                        dropout=0.0, **kw),
        "encoder": TransformerASR(
            tgt_vocab=V, input_size=32, d_model=D, nhead=4,
            num_encoder_layers=1, num_decoder_layers=0, d_ffn=64,
            dropout=0.0, encoder_module="conformer", kernel_size=7, **kw),
        "enc_proj": Linear(J, D, **kw),
        "emb": Embedding(V, 8, **kw),
        "dec": LSTM(12, 8, **kw),
        "dec_proj": Linear(J, 12, **kw),
        "joint": TransducerJoint(J, J, J, **kw),
        "out": Linear(V, J, **kw),
        "ctc_head": Linear(V, J, **kw),
    }


def _port_brain(variables):
    modules = load_modules(port_modules(), variables)
    hparams = {**_hparams(Fbank(n_mels=N_MELS, fused=True, device="cpu"),
                          InputNormalization(norm_type="sentence")),
               "lr_annealing": NewBobScheduler(8e-4)}
    return train.TransducerASR(modules=modules, hparams=hparams,
                               run_opts={"device": "cpu",
                                         "noprogressbar": True})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX brain with weights drawn into its variables, its first
    batch, and the twin's Brain over the same weights with its first
    batch."""
    paths = chip_smoke.write_asr_corpus(
        CFG, str(tmp_path_factory.mktemp("rnnt")))
    jb = _jax_brain()
    first = next(iter(jax_make_dataloader(_jax_dataset(paths["train"]),
                                          **LOADER)))
    jbatch = jb._prepare_batch(first)
    shapes = jax.eval_shape(lambda rng: jb.init_forward(rng, jbatch),
                            jax.random.PRNGKey(0))
    variables = draw_from_shapes(shapes, seed=0)
    pb = _port_brain(variables)
    ds = chip_smoke.asr_dataset(paths["train"], CFG, train=True, fold=True)
    batch = pb._prepare_batch(next(iter(pb.make_dataloader(
        ds, Stage.TRAIN, ckpt_prefix=None, **LOADER))))
    return jb, jbatch, variables, pb, batch


def test_the_twins_loss_matches_the_jax_recipe(setup):
    jb, jbatch, variables, pb, batch = setup
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jloss, _ = jax.jit(lambda p: jb._loss_and_aux(
        p, {}, jbatch, JaxStage.TRAIN, jb.rng))(jparams)
    pb.modules.train()
    predictions = pb.compute_forward(batch, Stage.TRAIN)
    assert len(predictions) == 3  # transducer log-probs, lengths, CTC
    assert predictions[0].shape[2] == batch["tokens"].data.shape[1] + 1
    ploss = pb.compute_objectives(predictions, batch, Stage.TRAIN)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)


def test_transcribe_batch_matches_the_jax_searcher(setup):
    """The twin's greedy ``transcribe_batch`` and the JAX searcher over the
    JAX recipe's modules on the same encoder frames: the same tokens."""
    jb, jbatch, variables, pb, batch = setup
    p = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    wavs, wav_lens = batch["sig"]
    searcher = pb.make_searcher(beam_size=1, max_symbols_per_step=2)
    got, _, _, _ = pb.transcribe_batch(wavs, wav_lens, searcher)
    enc, enc_lens = pb.encode(wavs, wav_lens)
    n = int(round(float(enc_lens.max()) * enc.shape[1]))

    def apply(name, *args, **kwargs):
        return getattr(jb.modules, name).apply({"params": p[name]}, *args,
                                               **kwargs)

    def pred_step(tokens, hidden):
        out, hidden = apply("dec", apply("emb", tokens), hx=hidden)
        return apply("dec_proj", out), hidden

    jsearch = JaxSearcher(pred_step, lambda a, b: apply("joint", a, b),
                          lambda x: apply("out", x), blank_id=0,
                          beam_size=1, max_symbols_per_step=2)
    want, *_ = jsearch(jnp.asarray(enc[:, :n].detach().numpy()))
    assert got == want
    assert n < enc.shape[1]  # the padding to 128 frames was cut


def test_the_streaming_configuration_takes_a_step(tmp_path):
    """The streaming YAML's hparams (``streaming`` and its sampler, drawing
    a chunked configuration) build the Brain, which takes one optimizer
    step with a finite loss and a chunked encode."""
    from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
        DynChunkTrainConfig,
        DynChunkTrainConfigRandomSampler,
    )

    torch.manual_seed(0)
    sampler = DynChunkTrainConfigRandomSampler(
        chunkwise_prob=1.0, chunk_size_min=4, chunk_size_max=4,
        valid_config=DynChunkTrainConfig(4, 2))
    hparams = {**_hparams(Fbank(n_mels=N_MELS, fused=True, device="cpu"),
                          InputNormalization(norm_type="sentence")),
               "streaming": True, "dynchunktrain_config_sampler": sampler,
               "lr_annealing": NewBobScheduler(8e-4)}
    brain = train.TransducerASR(
        modules=port_modules(), hparams=hparams,
        opt_class=chip_smoke.recipe.adamw(8e-4),
        run_opts={"device": "cpu", "noprogressbar": True})
    assert brain.chunk_config(Stage.TRAIN).chunk_size == 4
    assert brain.chunk_config(Stage.VALID) == DynChunkTrainConfig(4, 2)
    paths = chip_smoke.write_asr_corpus(CFG, str(tmp_path))
    ds = chip_smoke.asr_dataset(paths["train"], CFG, train=True, fold=True)
    batch = next(iter(brain.make_dataloader(ds, Stage.TRAIN,
                                            ckpt_prefix=None, **LOADER)))
    brain.init_optimizers()
    before = [p.detach().clone() for p in brain.modules.parameters()]
    brain.modules.train()
    brain.fit_batch(batch)
    loss = brain._flush_pending_loss()
    assert brain.optimizer_step == 1 and np.isfinite(loss)
    assert any(not torch.equal(a, p) for a, p in
               zip(before, brain.modules.parameters()))


# tests/recipes/recipes.csv, the LibriSpeech transducer row
FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=2 "
         "--vocab_size=32 --d_model=32 --nhead=4 --d_ffn=64 "
         "--num_encoder_layers=2 --joint_dim=32 --dec_neurons=32 "
         "--emb_size=16").split()


def test_the_twin_runs_from_its_yaml(tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m",
         "speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transducer.train",
         str(TWIN / "hparams" / "conformer_transducer.yaml"),
         f"--data_folder={tmp_path / 'data'}", f"--output_folder={out}",
         "--device=cpu", "--noprogressbar", *FLAGS],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any((out / "save").glob("CKPT*"))


def test_transducer_path_configuration_is_the_yaml():
    cfg = chip_smoke.TRANSDUCER_CFG
    twin = _scalars(TWIN / "hparams" / "conformer_transducer.yaml")
    for key, yaml_key in (
        ("n_mels", "n_mels"), ("n_fft", "n_fft"), ("d_model", "d_model"),
        ("nhead", "nhead"), ("d_ffn", "d_ffn"),
        ("enc_layers", "num_encoder_layers"), ("kernel_size", "kernel_size"),
        ("dropout", "transformer_dropout"), ("joint_dim", "joint_dim"),
        ("dec_neurons", "dec_neurons"), ("emb_size", "emb_size"),
        ("vocab", "vocab_size"), ("blank", "blank_index"), ("lr", "lr"),
        ("ctc_weight", "ctc_weight"), ("batch_size", "batch_size"),
    ):
        assert cfg[key] == twin[yaml_key], key
    text = (TWIN / "hparams" / "conformer_transducer.yaml").read_text()
    assert "out_channels: !tuple (64, 32)" in text
    assert cfg["fe_channels"] == (64, 32)
    assert "joint: sum" in text and cfg["joint"] == "sum"
    # the twin YAML holds the JAX recipe's values
    jax_yaml = _scalars(RECIPE / "hparams" / "conformer_transducer.yaml")
    assert jax_yaml == {k: v for k, v in twin.items() if k != "device"}
    # the searcher's settings are the JAX searcher's defaults
    import inspect

    defaults = {k: v.default for k, v in inspect.signature(
        JaxSearcher.__init__).parameters.items()
        if v.default is not inspect.Parameter.empty}
    for key in ("beam_size", "nbest", "state_beam", "expand_beam",
                "max_symbols_per_step"):
        assert chip_smoke.TRANSDUCER_DECODE[key] == defaults[key], key
