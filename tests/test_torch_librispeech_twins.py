"""The LibriSpeech CTC, BayesSpeech and Transformer-LM twins against the JAX
recipes at a small size:

- the CTC twin (``speechbrain_tpu_torch/recipes/LibriSpeech/ASR/CTC``):
  its float32 loss on one batch and its greedy ``transcribe_batch``
  against the JAX recipe's (``recipes/LibriSpeech/ASR/CTC/train.py``,
  imported as it is), and its ``dataio_prepare`` (character encoder,
  blank, targets) against JAX's;
- BayesSpeech (``.../ASR/transformer/train_bayesspeech.py``): the KL to the
  prior, the evaluation forward on ``mu`` and one forward at sampled
  weights ``mu + softplus(rho) * eps`` with the same ``eps`` from numpy on
  both sides, against JAX's, the posterior's ``{"mu", "rho"}`` tree
  carried through ``utils/jax_bridge.load_posterior``;
- every twin run from its YAML at the debug flags of
  ``tests/recipes/recipes.csv`` (CTC ``train.yaml``, ``bayesspeech.yaml``,
  the LM twin with ``transformer.yaml``), the two other CTC YAMLs built,
  and each twin YAML's scalars equal to the JAX YAML's.

Weights come from a numpy seed in the JAX recipes' variables. The JAX
features come from its unfused ``Fbank``, the port's from the fused one
(on the CPU its plain version). Tolerances: losses 1e-4 relative,
log-probabilities 1e-4 absolute, the KL 1e-5 relative (a float32 sum over
every weight in another order), tokens equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy
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
from speechbrain_tpu.lobes.features import Fbank as JaxFbank
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxTransformerASR,
)
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.schedulers import NoamScheduler
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train as ctc_twin,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer import (
    train_bayesspeech as bayes_twin,
)
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import (
    load_modules,
    load_posterior,
)
from test_torch_rnn import draw_from_shapes
from test_torch_seq2seq_recipe import _scalars

ROOT = Path(__file__).resolve().parents[1]
LS = ROOT / "recipes" / "LibriSpeech"
TWINS = ROOT / "speechbrain_tpu_torch" / "recipes" / "LibriSpeech"
LOSS_RTOL = 1e-4
LOGP_ATOL = 1e-4
KL_RTOL = 1e-5
V, N_MELS, D = 9, 16, 32
CFG = dict(vocab=V, n_train=4, n_valid=2, seconds=(0.4, 0.5),
           n_tokens=(3, 5), bos=1, eos=2)
LOADER = {"batch_size": 2, "pad_to_multiple": {"sig": 16000}}

# tests/recipes/recipes.csv, the rows of the three twins
DEBUG_RUNS = {
    "ctc": ("speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC.train",
            TWINS / "ASR" / "CTC" / "hparams" / "train.yaml",
            "--debug --debug_batches=2 --debug_epochs=1 --batch_size=4 "
            "--num_encoder_layers=2 --d_model=32 --d_ffn=64 --nhead=4"),
    "bayesspeech": (
        "speechbrain_tpu_torch.recipes.LibriSpeech.ASR.transformer"
        ".train_bayesspeech",
        TWINS / "ASR" / "transformer" / "hparams" / "bayesspeech.yaml",
        "--debug --debug_batches=2 --debug_epochs=1 --batch_size=2 "
        "--vocab_size=39 --d_model=32 --d_ffn=64 --nhead=4 "
        "--num_encoder_layers=2 --num_decoder_layers=1"),
    "transformer_lm": (
        "speechbrain_tpu_torch.recipes.LibriSpeech.LM.train",
        TWINS / "LM" / "hparams" / "transformer.yaml",
        "--debug --debug_batches=2 --debug_epochs=1 --batch_size=4 "
        "--output_neurons=32 --d_model=32 --nhead=4 --num_layers=2 "
        "--d_ffn=64"),
}


@pytest.fixture(scope="module", autouse=True)
def debug_runs(tmp_path_factory):
    """The three twins started in subprocesses with the module's first
    test, side by side with it; a test waits for its own."""
    tmp = tmp_path_factory.mktemp("twin_runs")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = {}
    for name, (module, yaml, flags) in DEBUG_RUNS.items():
        out = tmp / name
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", module, str(yaml),
             f"--data_folder={tmp / 'data' / name}",
             f"--output_folder={out}", "--device=cpu", "--noprogressbar",
             *flags.split()],
            cwd=tmp, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))

    def wait(name):
        out, proc = procs[name]
        _, stderr = proc.communicate(timeout=240)
        return out, proc.returncode, stderr

    yield wait
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _load_recipe(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    paths = chip_smoke.write_asr_corpus(
        CFG, str(tmp_path_factory.mktemp("twins")))
    jbatch = next(iter(jax_make_dataloader(_jax_dataset(paths["train"]),
                                           **LOADER)))
    ds = chip_smoke.asr_dataset(paths["train"], CFG, train=True, fold=True)
    batch = next(iter(chip_smoke.make_dataloader(ds, **LOADER)))
    return jbatch, batch


def _jax_frontend():
    return JaxFrontEnd(num_blocks=2, out_channels=(4, 8),
                       kernel_sizes=(3, 3), strides=(2, 2), dropout=0.0)


def _frontend():
    return ConvolutionFrontEnd(num_blocks=2, out_channels=(4, 8),
                               kernel_sizes=(3, 3), strides=(2, 2),
                               dropout=0.0, device="cpu")


def _variables(jb, jbatch, seed):
    shapes = jax.eval_shape(lambda rng: jb.init_forward(rng, jbatch),
                            jax.random.PRNGKey(0))
    return draw_from_shapes(shapes, seed=seed)


# -- the CTC twin -----------------------------------------------------------

def _ctc_brains(jbatch):
    jb = _load_recipe(LS / "ASR" / "CTC" / "train.py", "ls_ctc_train").ASRCTC(
        modules={
            "frontend": _jax_frontend(),
            "encoder": JaxTransformerASR(
                tgt_vocab=V, input_size=32, d_model=D, nhead=4,
                num_encoder_layers=1, num_decoder_layers=0, d_ffn=64,
                dropout=0.0, encoder_module="conformer",
                attention_type="RelPosMHAXL", kernel_size=7),
            "ctc_head": JaxLinear(n_neurons=V),
        },
        hparams={"compute_features": JaxFbank(n_mels=N_MELS),
                 "normalize": JaxNorm(norm_type="sentence"),
                 "blank_index": 0},
        run_opts={"noprogressbar": True})
    jbatch = jb._prepare_batch(jbatch)
    variables = _variables(jb, jbatch, seed=0)
    modules = load_modules({
        "frontend": _frontend(),
        "encoder": TransformerASR(
            tgt_vocab=V, input_size=32, d_model=D, nhead=4,
            num_encoder_layers=1, num_decoder_layers=0, d_ffn=64,
            dropout=0.0, encoder_module="conformer",
            attention_type="RelPosMHAXL", kernel_size=7, device="cpu"),
        "ctc_head": Linear(V, D, device="cpu"),
    }, variables)
    pb = ctc_twin.ASRCTC(
        modules=modules,
        hparams={"compute_features": Fbank(n_mels=N_MELS, fused=True,
                                           device="cpu"),
                 "normalize": InputNormalization(norm_type="sentence"),
                 "blank_index": 0},
        run_opts={"device": "cpu", "noprogressbar": True})
    jb.params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jb.model_state = {}
    return jb, jbatch, pb


def test_ctc_twin_loss_and_greedy_transcription_match_jax(corpus):
    jbatch, batch = corpus
    jb, jbatch, pb = _ctc_brains(jbatch)
    # the JAX recipe's own methods, its forward compiled once
    jb.compute_forward = jax.jit(jb.compute_forward, static_argnums=(3,))
    preds, _ = jb.compute_forward(jb.params, {}, jbatch, JaxStage.TEST,
                                  jb.rng)
    jloss = jb.compute_objectives(preds, jbatch, JaxStage.TEST)
    batch = pb._prepare_batch(batch)
    pb.modules.eval()
    ploss = pb.compute_objectives(pb.compute_forward(batch, Stage.TEST),
                                  batch, Stage.TEST)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)
    want = jb.transcribe_batch(jbatch)
    got = pb.transcribe_batch(batch)
    assert got == want
    assert any(got)


def test_ctc_dataio_prepare_matches_jax(tmp_path):
    """Both recipes' ``dataio_prepare`` over ``prepare_synthetic``'s
    corpus: the same blank index, character file and targets."""
    from speechbrain_tpu_torch.recipes.LibriSpeech.librispeech_prepare \
        import prepare_synthetic

    prepare_synthetic(str(tmp_path / "data"))
    hp = {"data_folder": str(tmp_path / "data"),
          "train_annotation": str(tmp_path / "data" / "train.json"),
          "valid_annotation": str(tmp_path / "data" / "dev.json")}
    jrecipe = _load_recipe(LS / "ASR" / "CTC" / "train.py", "ls_ctc_prep")
    jhp = dict(hp, save_folder=str(tmp_path / "jax"))
    php = dict(hp, save_folder=str(tmp_path / "port"))
    os.makedirs(jhp["save_folder"])
    os.makedirs(php["save_folder"])
    jdata = jrecipe.dataio_prepare(jhp)
    pdata = ctc_twin.dataio_prepare(php)
    assert php["blank_index"] == jhp["blank_index"]
    assert (Path(php["save_folder"]) / "char_encoder.txt").read_text() == \
        (Path(jhp["save_folder"]) / "char_encoder.txt").read_text()
    for split in ("train", "valid"):
        for i in range(len(jdata[split])):
            assert pdata[split][i]["tokens"].tolist() == \
                np.asarray(jdata[split][i]["tokens"]).tolist()


# -- BayesSpeech ------------------------------------------------------------

def _bayes_brains(jbatch):
    jrecipe = _load_recipe(
        LS / "ASR" / "transformer" / "train_bayesspeech.py", "ls_bayes")
    jb = jrecipe.BayesASR(
        modules={
            "frontend": _jax_frontend(),
            "model": JaxTransformerASR(
                tgt_vocab=V, input_size=32, d_model=D, nhead=4,
                num_encoder_layers=1, num_decoder_layers=1, d_ffn=64,
                dropout=0.0),
            "ctc_head": JaxLinear(n_neurons=V),
            "seq_head": JaxLinear(n_neurons=V),
        },
        hparams={"compute_features": JaxFbank(n_mels=N_MELS),
                 "normalize": JaxNorm(norm_type="sentence"),
                 "blank_index": 0, "ctc_weight": 0.3,
                 "label_smoothing": 0.1, "kl_div_weight": 1e-3,
                 "prior_std": 0.1},
        run_opts={"noprogressbar": True})
    jbatch = jb._prepare_batch(jbatch)
    variables = _variables(jb, jbatch, seed=5)
    # rho about its initial -5, so that softplus(rho) is of its scale
    rng = np.random.default_rng(6)
    variables["params"]["rho"] = jax.tree_util.tree_map(
        lambda r: (-5.0 + 0.5 * rng.standard_normal(r.shape)).astype(
            np.float32), variables["params"]["rho"])
    modules = {
        "frontend": _frontend(),
        "model": TransformerASR(
            tgt_vocab=V, input_size=32, d_model=D, nhead=4,
            num_encoder_layers=1, num_decoder_layers=1, d_ffn=64,
            dropout=0.0, device="cpu"),
        "ctc_head": Linear(V, D, device="cpu"),
        "seq_head": Linear(V, D, device="cpu"),
    }
    modules["rho"] = bayes_twin.PosteriorRho(modules)
    load_posterior(modules, variables)
    pb = bayes_twin.BayesASR(
        modules=modules,
        hparams={"compute_features": Fbank(n_mels=N_MELS, fused=True,
                                           device="cpu"),
                 "normalize": InputNormalization(norm_type="sentence"),
                 "blank_index": 0, "ctc_weight": 0.3,
                 "label_smoothing": 0.1, "kl_div_weight": 1e-3,
                 "prior_std": 0.1,
                 "noam_scheduler": NoamScheduler(8e-4, 10)},
        run_opts={"device": "cpu", "noprogressbar": True})
    return jrecipe, jb, jbatch, variables, pb


@pytest.fixture(scope="module")
def bayes(corpus):
    """The JAX recipe, its Brain with its forward at ``(mu, rho)`` on the
    first batch compiled once, the drawn variables, the twin's Brain and
    its batch."""
    jbatch, batch = corpus
    jrecipe, jb, jbatch, variables, pb = _bayes_brains(jbatch)
    forward = jax.jit(lambda p: jb.compute_forward(
        p, {}, jbatch, JaxStage.VALID, jb.rng)[0])
    jb.forward_at = lambda mu, rho: forward(jax.tree_util.tree_map(
        jnp.asarray, {"mu": mu, "rho": rho}))
    return jrecipe, jb, jbatch, variables, pb, pb._prepare_batch(batch)


def test_kl_to_prior_matches_jax(bayes):
    jrecipe, _, _, variables, pb, _ = bayes
    want = jrecipe._kl_to_prior(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), 0.1)
    got = pb.kl_to_prior().detach()
    assert float(got) == pytest.approx(float(want), rel=KL_RTOL)
    assert pb.modules["rho"].get("ctc_head", "weight").shape == (V, D)


def test_bayes_evaluation_forward_on_mu_matches_jax(bayes):
    _, jb, jbatch, variables, pb, batch = bayes
    p = variables["params"]
    want = jb.forward_at(p["mu"], p["rho"])
    pb.modules.eval()
    got = pb.compute_forward(batch, Stage.VALID)
    for ours, ref in zip(got, want[:2]):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   atol=LOGP_ATOL)
    jloss = jb.compute_objectives(want, jbatch, JaxStage.VALID)
    ploss = pb.compute_objectives(got, batch, Stage.VALID)
    assert float(ploss.detach()) == pytest.approx(float(jloss),
                                                  rel=LOSS_RTOL)


def test_bayes_sampled_forward_with_the_same_eps_matches_jax(bayes):
    """``eps`` drawn with numpy in JAX's tree: JAX computes ``mu +
    softplus(rho) * eps`` and runs on it; the port takes the same ``eps``
    through the bridge's layout and samples with it."""
    _, jb, jbatch, variables, pb, batch = bayes
    p = variables["params"]
    rng = np.random.default_rng(7)
    eps = jax.tree_util.tree_map(
        lambda m: rng.standard_normal(m.shape).astype(np.float32), p["mu"])
    theta = jax.tree_util.tree_map(
        lambda m, r, e: m + np.asarray(jax.nn.softplus(r)) * e,
        p["mu"], p["rho"], eps)
    want = jb.forward_at(theta, p["rho"])
    means = {k: v for k, v in pb.modules.items() if k != "rho"}
    shadow = load_modules(copy.deepcopy(means), eps)
    port_eps = {name: dict(m.named_parameters())
                for name, m in shadow.items()}
    pb.modules.train()
    sampled = pb.modules["rho"].sample(pb.modules, eps=port_eps)
    got = pb.forward_with(batch, sampled)
    for ours, ref in zip(got, want[:2]):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   atol=LOGP_ATOL)
    # and it is not the forward on mu
    on_mu = pb.forward_with(batch, None)
    assert (got[0] - on_mu[0]).abs().max() > 10 * LOGP_ATOL


def test_bayes_training_step_moves_mu_and_rho(bayes):
    """One training micro-batch through the Brain: the weights are drawn
    from its generator, the gradient reaches ``mu`` and ``rho``, and the
    optimizer (which holds both) moves them."""
    *_, pb, batch = bayes
    brain = bayes_twin.BayesASR(
        modules={k: copy.deepcopy(v) for k, v in pb.modules.items()},
        opt_class=ctc_twin.adamw(1e-3), hparams=vars(pb.hparams),
        run_opts={"device": "cpu", "noprogressbar": True})
    brain.init_optimizers()
    brain.modules.train()
    before = {k: v.clone() for k, v in brain.modules.state_dict().items()}
    brain.fit_batch(batch)
    assert np.isfinite(brain._flush_pending_loss())
    after = brain.modules.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "rho.rho.ctc_head.weight" in moved
    assert "ctc_head.weight" in moved
    assert float(brain.last_kl) > 0


# -- the twins from their YAMLs ----------------------------------------------

@pytest.mark.parametrize("name", list(DEBUG_RUNS))
def test_the_twins_run_from_their_yamls(debug_runs, name):
    out, rc, stderr = debug_runs(name)
    assert rc == 0, stderr[-3000:]
    log = (out / "train_log.txt").read_text()
    losses = [float(v) for v in re.findall(r"loss: ([0-9.e+-]+)", log)]
    assert "epoch: 1" in log and len(losses) == 2
    assert all(np.isfinite(losses))
    assert any((out / "save").glob("CKPT*"))


@pytest.mark.parametrize("yaml,encoder", [
    ("conformer_large.yaml", "ConformerEncoder"),
    ("branchformer_large.yaml", "BranchformerEncoder"),
])
def test_the_other_ctc_yamls_build_their_models(yaml, encoder, tmp_path):
    overrides = {"num_encoder_layers": 1, "d_model": 32, "d_ffn": 64,
                 "nhead": 4, "device": "cpu",
                 "data_folder": str(tmp_path),
                 "output_folder": str(tmp_path / "out")}
    hparams = load_hyperpyyaml(
        (TWINS / "ASR" / "CTC" / "hparams" / yaml).read_text(), overrides)
    assert type(hparams["encoder"].encoder).__name__ == encoder
    assert hparams["ctc_head"].weight.shape == (33, 32)
    hparams["blank_index"] = 0
    brain = ctc_twin.ASRCTC(modules=hparams["modules"], hparams=hparams,
                            run_opts={"device": "cpu"})
    wavs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16000)).astype(np.float32))
    hyps = brain.transcribe_batch({"sig": (wavs, torch.tensor([1.0, 0.7]))})
    assert len(hyps) == 2


@pytest.mark.parametrize("twin", [
    "ASR/CTC/hparams/train.yaml",
    "ASR/CTC/hparams/conformer_large.yaml",
    "ASR/CTC/hparams/branchformer_large.yaml",
    "ASR/transformer/hparams/bayesspeech.yaml",
    "LM/hparams/transformer.yaml",
])
def test_twin_yaml_scalars_are_the_jax_yamls(twin):
    want = _scalars(LS / twin)
    got = _scalars(TWINS / twin)
    assert got.pop("device") == "cuda"
    assert got == want


def test_ctc_path_configuration_is_the_yamls():
    cfg = chip_smoke.CTC_CFG
    for name, family in chip_smoke.CTC_FAMILIES.items():
        y = _scalars(TWINS / "ASR" / "CTC" / "hparams" / f"{name}.yaml")
        text = (TWINS / "ASR" / "CTC" / "hparams" / f"{name}.yaml")\
            .read_text()
        for key, yaml_key in (("d_model", "d_model"), ("nhead", "nhead"),
                              ("enc_layers", "num_encoder_layers"),
                              ("d_ffn", "d_ffn")):
            assert family[key] == y[yaml_key], (name, key)
        for key, yaml_key in (("kernel_size", "kernel_size"),
                              ("dropout", "dropout"), ("lr", "lr"),
                              ("batch_size", "batch_size"),
                              ("vocab", "output_neurons"),
                              ("n_mels", "n_mels")):
            assert cfg[key] == y[yaml_key], (name, key)
        assert f"encoder_module: {family['encoder_module']}" in text
    b = _scalars(TWINS / "ASR" / "transformer" / "hparams"
                 / "bayesspeech.yaml")
    bc = chip_smoke.BAYES_CFG
    for key, yaml_key in (
        ("d_model", "d_model"), ("nhead", "nhead"),
        ("enc_layers", "num_encoder_layers"),
        ("dec_layers", "num_decoder_layers"), ("d_ffn", "d_ffn"),
        ("dropout", "transformer_dropout"), ("vocab", "vocab_size"),
        ("ctc_weight", "ctc_weight"), ("label_smoothing", "label_smoothing"),
        ("kl_div_weight", "kl_div_weight"), ("prior_std", "prior_std"),
        ("lr_adam", "lr_adam"), ("n_warmup_steps", "n_warmup_steps"),
        ("batch_size", "batch_size"),
        ("grad_accumulation_factor", "grad_accumulation_factor"),
        ("max_grad_norm", "max_grad_norm"), ("bos", "bos_index"),
        ("eos", "eos_index"), ("blank", "blank_index"),
    ):
        assert bc[key] == b[yaml_key], key
    lm = _scalars(TWINS / "LM" / "hparams" / "transformer.yaml")
    tc = chip_smoke.TLM_CFG
    for key, yaml_key in (("vocab", "output_neurons"),
                          ("d_model", "d_model"), ("nhead", "nhead"),
                          ("layers", "num_layers"), ("d_ffn", "d_ffn"),
                          ("dropout", "dropout"), ("lr", "lr"),
                          ("batch_size", "batch_size"),
                          ("bos", "bos_index"), ("eos", "eos_index")):
        assert tc[key] == lm[yaml_key], key
