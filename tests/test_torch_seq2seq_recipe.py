"""The recurrent recipes' training side against the JAX package: NewBob and
Adadelta against JAX's scheduler and ``optax.adadelta`` over three steps;
the CRDNN twin's float32 loss on one batch against the JAX recipe's
(``recipes/LibriSpeech/ASR/seq2seq/train.py``, imported as it is) at
dropout 0, with the BatchNorms' running statistics after that forward;
both twins (``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/seq2seq`` and
``.../LM``) run from their YAMLs at the debug flags of
``tests/recipes/recipes.csv``; a checkpoint round trip that carries the
running statistics; and ``chip_smoke.py``'s ``crdnn_path`` configuration
against the twin YAMLs' values.

Weights come from a numpy seed in the JAX recipe's variables (shapes from
``jax.eval_shape`` of its ``init_forward``). The JAX features come from
its unfused ``Fbank``, the port's from the fused one (on the CPU its plain
version). Tolerances: losses 1e-4 relative; running statistics 1e-5;
optimizer states and parameters 1e-6."""

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
from speechbrain_tpu.dataio.dataio import read_audio as jax_read_audio
from speechbrain_tpu.dataio.dataloader import (
    make_dataloader as jax_make_dataloader,
)
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JaxCRDNN
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.RNN import AttentionalRNNDecoder as JaxDecoder
from speechbrain_tpu.nnet.schedulers import NewBobScheduler as JaxNewBob
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.dataio.dataloader import make_dataloader
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.RNN import AttentionalRNNDecoder
from speechbrain_tpu_torch.nnet.schedulers import NewBobScheduler
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq import train
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_rnn import draw_from_shapes

ROOT = Path(__file__).resolve().parents[1]
RECIPE = ROOT / "recipes" / "LibriSpeech" / "ASR" / "seq2seq"
TWINS = ROOT / "speechbrain_tpu_torch" / "recipes" / "LibriSpeech"
LOSS_RTOL = 1e-4
STATS_ATOL = 1e-5
V = 20
CFG = dict(vocab=V, n_train=4, n_valid=2, seconds=(0.4, 0.5),
           n_tokens=(3, 5), bos=0, eos=0)
SMALL = dict(cnn_channels=(4, 8), inter_layer_pooling_size=(2, 2),
             time_pooling=True, time_pooling_size=4, rnn_layers=1,
             rnn_neurons=8, dnn_blocks=1, dnn_neurons=12)


# -- schedulers and the optimizer ----------------------------------------

@pytest.mark.parametrize("patient", [0, 1])
def test_newbob_matches_jax(patient, tmp_path):
    metrics = [3.0, 2.5, 2.6, 2.59, 2.0, 2.0, 1.99, 2.4]
    ours = NewBobScheduler(1.0, annealing_factor=0.8, patient=patient)
    ref = JaxNewBob(1.0, annealing_factor=0.8, patient=patient)
    for m in metrics:
        assert ours(m) == ref(m)
    ours._save(tmp_path / "nb.json")
    again = NewBobScheduler(1.0, annealing_factor=0.8, patient=patient)
    again._load(tmp_path / "nb.json")
    assert again(1.5) == ref(1.5)


def test_adadelta_matches_optax_over_three_steps():
    """``torch.optim.Adadelta`` as the twin makes it against
    ``optax.adadelta(1.0, rho=0.95, eps=1e-8)`` on the same gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = train.adadelta(1.0)([param])
    tx = optax.adadelta(1.0, rho=0.95, eps=1e-8)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   atol=1e-6)


# -- the twin's loss against the JAX recipe's ------------------------------

def _recipe():
    spec = importlib.util.spec_from_file_location(
        "librispeech_seq2seq_train", RECIPE / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fold(text):
    return [1 + int(t) % (V - 1) for t in text.split()]


def _jax_dataset(manifest):
    ds = JaxDataset.from_json(manifest).filtered_sorted(sort_key="length")
    ds.add_dynamic_item(jax_read_audio, takes="wav", provides="sig")

    def tokens_pipeline(text):
        ids = _fold(text)
        yield np.asarray(ids, np.int32)
        yield np.asarray([CFG["bos"]] + ids, np.int32)
        yield np.asarray(ids + [CFG["eos"]], np.int32)

    ds.add_dynamic_item(tokens_pipeline, takes="tokens",
                        provides=["tokens_ids", "tokens_bos", "tokens_eos"])
    ds.set_output_keys({"id": "id", "sig": "sig", "tokens": "tokens_ids",
                        "tokens_bos": "tokens_bos",
                        "tokens_eos": "tokens_eos"})
    return ds


def _hparams(fbank, norm):
    return {"compute_features": fbank, "normalize": norm, "ctc_weight": 0.5,
            "label_smoothing": 0.1, "blank_index": 0}


def _jax_brain():
    modules = {
        "enc": JaxCRDNN(dropout=0.0, **SMALL),
        "emb": JaxEmbedding(num_embeddings=V, embedding_dim=8),
        "dec": JaxDecoder(hidden_size=10, attn_dim=6, attn_type="location",
                          channels=3, kernel_size=5),
        "seq_lin": JaxLinear(n_neurons=V),
        "ctc_lin": JaxLinear(n_neurons=V),
    }
    return _recipe().ASR(
        modules=modules,
        hparams=_hparams(JaxFbank(n_mels=16), JaxNorm(norm_type="sentence")),
        run_opts={"noprogressbar": True},
        opt_class=lambda: optax.adadelta(1.0, rho=0.95, eps=1e-8))


def port_modules(device="cpu"):
    return {
        "enc": CRDNN(input_size=16, dropout=0.0, device=device, **SMALL),
        "emb": Embedding(V, 8, device=device),
        "dec": AttentionalRNNDecoder(hidden_size=10, attn_dim=6,
                                     input_size=8, enc_dim=12, channels=3,
                                     kernel_size=5, device=device),
        "seq_lin": Linear(V, 10, device=device),
        "ctc_lin": Linear(V, 12, device=device),
    }


def _port_hparams():
    return {**_hparams(Fbank(n_mels=16, fused=True, device="cpu"),
                       InputNormalization(norm_type="sentence")),
            "lr_annealing": NewBobScheduler(1.0)}


def _port_dataset(manifest):
    return chip_smoke.asr_dataset(manifest, CFG, train=True, fold=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2s")
    return chip_smoke.write_asr_corpus(CFG, str(tmp))


LOADER = {"batch_size": 2, "pad_to_multiple": {"sig": 16000}}


def test_the_twins_loss_and_running_stats_match_the_jax_recipe(corpus):
    jb = _jax_brain()
    first = next(iter(jax_make_dataloader(_jax_dataset(corpus["train"]),
                                          **LOADER)))
    jbatch = jb._prepare_batch(first)
    shapes = jax.eval_shape(lambda rng: jb.init_forward(rng, jbatch),
                            jax.random.PRNGKey(0))
    variables = draw_from_shapes(shapes, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = {"batch_stats": jax.tree_util.tree_map(
        jnp.asarray, variables["batch_stats"])}
    jloss, (_, jnew) = jax.jit(lambda p, s: jb._loss_and_aux(
        p, s, jbatch, JaxStage.TRAIN, jb.rng))(jparams, jstate)

    modules = port_modules()
    load_modules(modules, variables)
    pb = train.ASR(modules=modules, hparams=_port_hparams(),
                   run_opts={"device": "cpu", "noprogressbar": True})
    pb.modules.train()
    batch = next(iter(pb.make_dataloader(_port_dataset(corpus["train"]),
                                         Stage.TRAIN, ckpt_prefix=None,
                                         **LOADER)))
    batch = pb._prepare_batch(batch)
    ploss = pb.compute_objectives(pb.compute_forward(batch, Stage.TRAIN),
                                  batch, Stage.TRAIN)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)
    ref = port_modules()
    load_modules(ref, {"params": variables["params"],
                       "batch_stats": jax.tree_util.tree_map(
                           np.asarray, jnew["batch_stats"])})
    bns = [m for m in pb.modules["enc"].modules()
           if isinstance(m, BatchNorm1d)]
    refs = [m for m in ref["enc"].modules() if isinstance(m, BatchNorm1d)]
    assert len(bns) == 1
    for a, b in zip(bns, refs):
        np.testing.assert_allclose(a.running_mean.numpy(),
                                   b.running_mean.numpy(), atol=STATS_ATOL)
        np.testing.assert_allclose(a.running_var.numpy(),
                                   b.running_var.numpy(), atol=STATS_ATOL)


def test_transcribe_dataset_matches_the_jax_recipe(tmp_path):
    """Both recipes' ``transcribe_dataset`` over ``prepare_synthetic``'s
    test split with one BPE model (the port's file, which the JAX
    tokenizer loads) and the same weights: the same words, the same WER."""
    from speechbrain_tpu.tokenizers.SentencePiece import (
        SentencePiece as JaxSentencePiece,
    )
    from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare \
        import prepare_synthetic
    from speechbrain_tpu_torch.tokenizers.SentencePiece import SentencePiece

    data = tmp_path / "data"
    prepare_synthetic(str(data))
    hp = {"data_folder": str(data), "bos_index": 0, "eos_index": 0,
          **{f"{split}_annotation": str(data / f"{name}.json")
             for split, name in (("train", "train"), ("valid", "dev"),
                                 ("test", "test"))}}
    tok = SentencePiece(model_dir=str(tmp_path / "tok"), vocab_size=V,
                        annotation_train=hp["train_annotation"],
                        annotation_read="words", model_type="bpe",
                        annotation_format="json")
    jtok = JaxSentencePiece(model_dir=str(tmp_path / "tok"), vocab_size=V,
                            model_type="bpe")
    search = {"min_decode_ratio": 0.0, "max_decode_ratio": 1.0,
              "eos_threshold": 1.5, "test_batch_size": 2, "bos_index": 0,
              "eos_index": 0, "output_neurons": V}
    jb = _jax_brain()
    jb.hparams.__dict__.update(search)
    jdata = _recipe().dataio_prepare(hp, jtok)
    first = next(iter(jax_make_dataloader(jdata["test"], batch_size=2)))
    shapes = jax.eval_shape(lambda rng: jb.init_forward(
        rng, jb._prepare_batch(first)), jax.random.PRNGKey(0))
    variables = draw_from_shapes(shapes, seed=4)
    jb.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jb.model_state = {"batch_stats": jax.tree_util.tree_map(
        jnp.asarray, variables["batch_stats"])}
    jwer = jb.transcribe_dataset(jdata["test"], jtok, beam_size=3)

    modules = port_modules()
    load_modules(modules, variables)
    pb = train.ASR(modules=modules, hparams={**_port_hparams(), **search},
                   run_opts={"device": "cpu", "noprogressbar": True})
    wer = pb.transcribe_dataset(train.dataio_prepare(hp, tok)["test"], tok,
                                beam_size=3)
    assert [s["hyp_tokens"] for s in wer.scores] == \
        [s["hyp_tokens"] for s in jwer.scores]
    assert wer.summarize("WER") == jwer.summarize("WER")
    assert len(wer.scores) == 2


# -- a checkpoint carries the running statistics ---------------------------

def test_checkpoint_round_trip_carries_running_stats(corpus, tmp_path):
    """Two Adadelta steps of the twin's Brain, then its valid stage (NewBob
    anneals, a checkpoint is kept); a fresh Brain recovers the checkpoint:
    every running statistic and weight, bit for bit."""
    def brain():
        torch.manual_seed(0)
        modules = port_modules()
        hparams = _port_hparams()
        ckpt = Checkpointer(str(tmp_path / "save"),
                            {"lr_annealing": hparams["lr_annealing"]})
        return train.ASR(modules=modules, hparams=hparams,
                         opt_class=train.adadelta(1.0), checkpointer=ckpt,
                         run_opts={"device": "cpu", "noprogressbar": True})

    trained = brain()
    ds = _port_dataset(corpus["train"])
    init = {k: v.clone() for k, v in trained.modules.state_dict().items()}
    trained.fit(EpochCounter(1), ds, ds, train_loader_kwargs=LOADER,
                valid_loader_kwargs=LOADER)
    state = trained.modules.state_dict()
    moved = [k for k in state if k.endswith("running_var")
             and not torch.equal(state[k], init[k])]
    assert moved
    fresh = brain()
    fresh.init_optimizers()
    assert fresh.checkpointer.recover_if_possible()
    for key, value in fresh.modules.state_dict().items():
        assert torch.equal(value, state[key]), key
    assert fresh.hparams.lr_annealing.metric_values == \
        trained.hparams.lr_annealing.metric_values


# -- both twins from their YAMLs --------------------------------------------

# tests/recipes/recipes.csv, the LibriSpeech seq2seq row
S2S_FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=4 "
             "--output_neurons=32 --cnn_blocks=1 --rnn_layers=1 "
             "--rnn_neurons=32 --dnn_blocks=1 --dnn_neurons=32 "
             "--dec_neurons=32 --attn_dim=32 --emb_size=16 "
             "--location_kernel=11").split()
LM_FLAGS = ("--debug --debug_batches=2 --debug_epochs=1 --batch_size=4 "
            "--output_neurons=32 --rnn_neurons=32 --dnn_neurons=16 "
            "--emb_size=8").split()


@pytest.fixture(scope="module")
def twin_runs(tmp_path_factory):
    """Both twins in subprocesses, run side by side."""
    tmp = tmp_path_factory.mktemp("twins")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = {}
    for name, module, yaml, flags in (
        ("seq2seq", "speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq"
         ".train", TWINS / "ASR" / "seq2seq" / "hparams"
         / "train_BPE_1000.yaml", S2S_FLAGS),
        ("lm", "speechbrain_tpu_torch.recipes.LibriSpeech.LM.train",
         TWINS / "LM" / "hparams" / "RNNLM.yaml", LM_FLAGS),
    ):
        out = tmp / name
        cmd = [sys.executable, "-m", module, str(yaml),
               f"--data_folder={tmp / 'data' / name}",
               f"--output_folder={out}", "--device=cpu",
               "--noprogressbar", *flags]
        runs[name] = (out, subprocess.Popen(
            cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = {}
    for name, (out, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=240)
        results[name] = (out, proc.returncode, stderr)
    return results


@pytest.mark.parametrize("name", ["seq2seq", "lm"])
def test_the_twins_run_from_their_yamls(twin_runs, name):
    out, rc, stderr = twin_runs[name]
    assert rc == 0, stderr[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any((out / "save").glob("CKPT*"))
    assert (out / "hyperparams.yaml").exists()


@pytest.mark.parametrize("yaml,rnn,vocab", [
    ("train_BPE_5000.yaml", "LSTM", 5000),
    ("train_BPE_1000_sligru.yaml", "SLiGRU", 1000),
])
def test_the_other_yamls_build_their_models(yaml, rnn, vocab, tmp_path):
    """The two other hparams files at the debug widths (the head's width
    as the file says): the encoder's recurrence, the heads, and one
    training forward of the twin's Brain on a batch of noise."""
    from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml

    flags = dict(f[2:].split("=") for f in S2S_FLAGS if "=" in f)
    overrides = {k: int(v) for k, v in flags.items()
                 if k not in ("debug_batches", "debug_epochs",
                              "output_neurons")}
    overrides.update(device="cpu", data_folder=str(tmp_path),
                     output_folder=str(tmp_path / "out"))
    text = (TWINS / "ASR" / "seq2seq" / "hparams" / yaml).read_text()
    hparams = load_hyperpyyaml(text, overrides)
    assert type(hparams["enc"].rnn).__name__ == rnn
    assert hparams["seq_lin"].weight.shape[0] == vocab
    brain = train.ASR(modules=hparams["modules"], hparams=hparams,
                      run_opts={"device": "cpu"})
    brain.modules.train()
    wavs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16000)).astype(np.float32))
    tokens = torch.tensor([[3, 4, 5], [6, 7, 0]])
    batch = {"sig": (wavs, torch.tensor([1.0, 0.8])),
             "tokens_bos": (torch.cat([torch.zeros(2, 1, dtype=torch.long),
                                       tokens], 1), torch.ones(2)),
             "tokens": (tokens, torch.tensor([1.0, 2 / 3])),
             "tokens_eos": (torch.cat([tokens, torch.zeros(
                 2, 1, dtype=torch.long)], 1), torch.tensor([1.0, 0.75]))}
    p_ctc, p_seq = brain.compute_forward(batch, Stage.TRAIN)
    assert p_ctc.shape == (2, 25, vocab) and p_seq.shape == (2, 4, vocab)
    loss = brain.compute_objectives((p_ctc, p_seq), batch, Stage.TRAIN)
    assert torch.isfinite(loss)


# -- the card's configuration is the YAMLs' ---------------------------------

def _scalars(path):
    """Top-level scalar entries of a YAML file, read as text."""
    values = {}
    for line in Path(path).read_text().splitlines():
        m = re.match(r"^(\w+): ([^!#\n]+?)\s*(#.*)?$", line)
        if m:
            try:
                values[m.group(1)] = json.loads(m.group(2))
            except ValueError:
                values[m.group(1)] = m.group(2)
    return values


def test_crdnn_path_configuration_is_the_yamls():
    cfg, dec = chip_smoke.CRDNN_CFG, chip_smoke.CRDNN_DECODE
    for yaml in ("train_BPE_1000.yaml", "train_BPE_1000_sligru.yaml"):
        y = _scalars(TWINS / "ASR" / "seq2seq" / "hparams" / yaml)
        for key, yaml_key in (
            ("n_mels", "n_mels"), ("n_fft", "n_fft"),
            ("rnn_layers", "rnn_layers"), ("rnn_neurons", "rnn_neurons"),
            ("dnn_blocks", "dnn_blocks"), ("dnn_neurons", "dnn_neurons"),
            ("emb_size", "emb_size"), ("dec_neurons", "dec_neurons"),
            ("attn_dim", "attn_dim"),
            ("location_channels", "location_channels"),
            ("location_kernel", "location_kernel"),
            ("vocab", "output_neurons"), ("bos", "bos_index"),
            ("eos", "eos_index"), ("blank", "blank_index"),
            ("dropout", "dropout"), ("lr", "lr"),
            ("ctc_weight", "ctc_weight"),
            ("label_smoothing", "label_smoothing"),
            ("batch_size", "batch_size"),
        ):
            assert cfg[key] == y[yaml_key], (yaml, key)
        assert dec["beam_size"] == y["test_beam_size"]
        assert dec["eos_threshold"] == y["eos_threshold"]
        assert dec["max_decode_ratio"] == y["max_decode_ratio"]
    lm = _scalars(TWINS / "LM" / "hparams" / "RNNLM.yaml")
    for key, yaml_key in (("lm_emb_size", "emb_size"),
                          ("lm_rnn_neurons", "rnn_neurons"),
                          ("lm_rnn_layers", "rnn_layers"),
                          ("lm_dnn_neurons", "dnn_neurons"),
                          ("lm_lr", "lr"), ("lm_batch_size", "batch_size"),
                          ("vocab", "output_neurons")):
        assert cfg[key] == lm[yaml_key], key
    # the twin YAMLs hold the JAX recipe's values
    jax_yaml = _scalars(RECIPE / "hparams" / "train_BPE_1000.yaml")
    twin = _scalars(TWINS / "ASR" / "seq2seq" / "hparams"
                    / "train_BPE_1000.yaml")
    assert {k: v for k, v in jax_yaml.items() if k != "device"} == \
        {k: v for k, v in twin.items() if k != "device"}
