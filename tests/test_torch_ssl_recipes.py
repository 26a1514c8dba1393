"""The self-supervised twins against the JAX package's recipes
(``recipes/LibriSpeech/self-supervised-learning/{wav2vec2,BEST-RQ}``,
``recipes/LibriSpeech/ASR/CTC`` ``train_with_{bestrq,wav2vec}``,
``recipes/Libri-Light/self-supervised-learning/{wav2vec2,BEST-RQ}``,
``recipes/CommonVoice/self-supervised-learning/wav2vec2``,
``recipes/DVoice/ASR/CTC`` ``train_with_wav2vec2``), on the CPU:

* every JAX YAML of the slice has its twin, and each twin's values, read
  as text, are the JAX YAML's (the twin adds ``device``, the seed's draw,
  the epoch counter among the checkpointer's recoverables, the input widths
  the port's constructors take, and the BEST-RQ YAMLs' fused ``Fbank``);
  each model YAML, cut to a small width in both packages, builds modules
  that take the JAX modules' variables, every key used;
* the Libri-Light and DVoice synthetic corpora against the JAX scripts',
  files and manifests byte for byte;
* one step of each objective on the same weights and draws: the wav2vec
  2.0 twin's loss (InfoNCE and the diversity term) and every gradient, the
  BEST-RQ twin's loss, accuracy and gradients, and the wav2vec CTC
  fine-tuning's loss and gradients, against the JAX scripts'
  ``compute_forward``/``compute_objectives`` (loss within 1e-5 relative,
  gradients within 1e-5 of the largest of their tensor);
* ROADMAP C53: the JAX fine-tuning collects the pretrained files and its
  parameters stay its fresh init; the port's chain pours them (C54: the
  relative-position tensors keep their init);
* the BEST-RQ chain through the CLIs in process (pretraining, export,
  fine-tuning from the export);
* ``chip_smoke.py``'s ``ssl_path`` on the CPU at a cut size, which runs
  each twin folder once (``torch.cuda``'s timing calls stubbed, B3's
  plain version counted as its launches).
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy
import importlib
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
import speechbrain_tpu as jsb
from speechbrain_tpu.core import Brain as JaxBrain
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models import wav2vec as jw2v
from speechbrain_tpu.lobes.models.convolution import (
    ConvolutionFrontEnd as JaxFrontEnd,
)
from speechbrain_tpu.lobes.models.transformer.Transformer import (
    TransformerEncoder as JaxEncoder,
)
from speechbrain_tpu.lobes.models.transformer.TransformerASR import (
    TransformerASR as JaxASR,
)
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.quantisers import (
    RandomProjectionQuantizer as JaxRPQ,
)
from speechbrain_tpu.processing import features as jprocessing
from speechbrain_tpu.utils.hyperyaml import load_hyperpyyaml as jax_load
from speechbrain_tpu_torch.core import Stage
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models import wav2vec as tw2v
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.quantisers import RandomProjectionQuantizer
from speechbrain_tpu_torch.ops import mel_frontend, refuse_autograd
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.DVoice.ASR.CTC import prepare as dv_prep
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train_with_bestrq as ft_brq,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.CTC import (
    train_with_wav2vec as ft_w2v,
)
from speechbrain_tpu_torch.utils.hyperyaml import load_hyperpyyaml
from speechbrain_tpu_torch.utils.jax_bridge import load_modules
from test_torch_frame_recipes import _load_script, _main, _scalars
from test_torch_rnn import draw_variables
from test_torch_speaker_recipe import _Event
from test_torch_ssl import EXT, SameDraws

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speechbrain_tpu_torch"
LOSS_RTOL = 1e-5
# of the largest magnitude of a gradient tensor; CTC: its forward-backward
# recursion over 398 frames runs in another order (optax's against torch's)
GRAD_RTOL = {"wav2vec2": 1e-5, "bestrq": 1e-5, "wav2vec_ctc": 1e-4}
# gradients that are zero in exact arithmetic (an attention key's bias)
# are float32 noise on both sides
GRAD_FLOOR = 1e-7
KEY = jax.random.PRNGKey(0)
LS_W2V = "recipes/LibriSpeech/self-supervised-learning/wav2vec2"
LS_BRQ = "recipes/LibriSpeech/self-supervised-learning/BEST-RQ"
LS_CTC = "recipes/LibriSpeech/ASR/CTC"
LL_W2V = "recipes/Libri-Light/self-supervised-learning/wav2vec2"
LL_BRQ = "recipes/Libri-Light/self-supervised-learning/BEST-RQ"
CV_W2V = "recipes/CommonVoice/self-supervised-learning/wav2vec2"
DVOICE = "recipes/DVoice/ASR/CTC"
DVOICE_YAMLS = ["train_with_wav2vec2.yaml"] + [
    f"train_{lang}_with_wav2vec.yaml"
    for lang in ("amh", "dar", "fon", "multi", "sw", "wol")]
YAMLS = [f"{LS_W2V}/hparams/train_sb_wav2vec2.yaml",
         f"{LS_BRQ}/hparams/bestrq.yaml",
         f"{LS_CTC}/hparams/train_with_bestrq.yaml",
         f"{LS_CTC}/hparams/train_with_wav2vec.yaml",
         f"{LL_W2V}/hparams/wav2vec2.yaml", f"{LL_BRQ}/hparams/bestrq.yaml",
         f"{CV_W2V}/hparams/train_hf_wav2vec2.yaml",
         *(f"{DVOICE}/hparams/{y}" for y in DVOICE_YAMLS)]
# every SSL YAML cut to a small width, as text, in either package
SMALL = [
    ("  out_channels: !tuple (512, 512, 512, 512, 512, 512, 512)\n", ""),
    ("models.wav2vec.W2VLatentExtractor\n",
     "models.wav2vec.W2VLatentExtractor\n  out_channels: !tuple (16, 16, 16)"
     "\n  kernel_sizes: !tuple (11, 3, 3)\n  strides: !tuple (5, 2, 2)\n"),
    ("latent_dim: 512", "latent_dim: 16"), ("target_dim: 256", "target_dim: 8"),
    ("d_model: 768", "d_model: 32"), ("d_model: 576", "d_model: 32"),
    ("d_ffn: 3072", "d_ffn: 32"), ("d_ffn: 2048", "d_ffn: 32"),
    ("nhead: 8", "nhead: 2"), ("num_layers: 12", "num_layers: 1"),
    ("num_encoder_layers: 12", "num_encoder_layers: 1"),
    ("quantiser_vars: 320", "quantiser_vars: 8"),
    ("num_negatives: 100", "num_negatives: 4"), ("cb_vocab: 8192", "cb_vocab: 64"),
    ("batch_size: 8", "batch_size: 2"), ("batch_size: 6", "batch_size: 2"),
    ("batch_size: 4", "batch_size: 2"), ("dropout: 0.1", "dropout: 0.0"),
]


def _small_text(path):
    text = Path(path).read_text()
    for old, new in SMALL:
        text = text.replace(old, new)
    return text


def test_every_jax_yaml_of_the_seven_folders_has_its_twin():
    jax_yamls = sorted(
        str(p.relative_to(ROOT)) for folder in (LS_W2V, LS_BRQ, LL_W2V, LL_BRQ,
                                                CV_W2V)
        for p in (ROOT / folder).rglob("*.yaml"))
    jax_yamls += [f"{LS_CTC}/hparams/train_with_bestrq.yaml",
                  f"{LS_CTC}/hparams/train_with_wav2vec.yaml"]
    jax_yamls += [str(p.relative_to(ROOT))
                  for p in (ROOT / DVOICE / "hparams").glob("*wav2vec*.yaml")]
    assert sorted(YAMLS) == sorted(jax_yamls) and len(YAMLS) == 14
    for yaml in YAMLS:
        assert (PORT / yaml).exists(), yaml


# -- data preparation --------------------------------------------------------

def _ll_prepare(folder):
    return importlib.import_module(
        "speechbrain_tpu_torch." + LL_W2V.replace("/", ".") + ".train"
    ).prepare_synthetic(folder)


PREPARES = {"libri-light": (f"{LL_W2V}/train.py", _ll_prepare,
                            ("train.json", "valid.json")),
            "dvoice": (f"{DVOICE}/prepare.py", dv_prep.prepare_synthetic,
                       ("train.json", "valid.json"))}


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

def _blocks(path):
    """Each top-level block with a tag or indented lines: its tag and
    lines, comments dropped, class paths read without their package's
    name (a ``!new:`` block may have no lines)."""
    text = Path(path).read_text().replace("speechbrain_tpu_torch.",
                                          "speechbrain_tpu.")
    return {m.group(1): (m.group(2), [
        line for line in m.group(3).splitlines()
        if not line.strip().startswith("#")])
        for m in re.finditer(r"^(\w+):( ?\S*)\n((?:  .*\n)*)", text + "\n",
                             re.M) if m.group(3) or "!new:" in m.group(2)}


ADDED_ARGS = (r"  device: !ref <device>", r"  input_size: !ref <latent_dim>",
              r"  input_size: !ref <d_model>", r"  recoverables:",
              r"    counter: !ref <epoch_counter>")


@pytest.mark.parametrize("yaml", YAMLS)
def test_twin_yaml_values_are_the_jax_yamls(yaml):
    """The JAX YAML's top-level scalars and each block's tag and lines are
    the twin's; the twin adds ``device``, the seed's draw, the lines of
    ``ADDED_ARGS`` and, in the BEST-RQ YAMLs, ``fused: True`` on the
    Fbank."""
    jpath, tpath = ROOT / yaml, PORT / yaml
    j, t = _scalars(jpath), _scalars(tpath)
    assert t.pop("device") == "cuda"
    assert t.pop("__set_seed").startswith("!apply:")
    j.pop("__set_seed", None)
    assert t == j
    jb, tb = _blocks(jpath), _blocks(tpath)
    assert sorted(jb) == sorted(tb)
    bestrq = "bestrq" in yaml
    for key, (jtag, jargs) in jb.items():
        ttag, targs = tb[key]
        assert ttag == jtag, key
        assert targs[:len(jargs)] == jargs, key
        added = targs[len(jargs):]
        if bestrq and key == "compute_features":
            assert added[0] == "  fused: True"
            added = added[1:]
        for line in added:
            assert any(re.fullmatch(p, line) for p in ADDED_ARGS), (key, line)
    assert ("fused: True" in tpath.read_text()) == bestrq


def _example_inputs(name, jh, B=1, T=4000):
    """Example inputs of a JAX module of the SSL YAMLs, by its name."""
    wav, feats = jnp.zeros((B, T)), jnp.zeros((B, 26, 80))
    lat = None
    if "extractor" in jh:
        lat = jnp.zeros(jax.eval_shape(
            lambda: jh["extractor"].init_with_output(KEY, wav)[0]).shape)
    hidden = jnp.zeros((B, 9, jh["d_model"]))
    table = {
        "extractor": ((wav,), {}),
        "quantizer": ((lat,), {"train": False}) if lat is not None
        else ((feats,), {}),
        "latent_proj": ((lat,), {}),
        "frontend": ((feats,), {"train": False}),
        "encoder": ((jnp.zeros((B, 7, 640)),), {"method": "encode"})
        if isinstance(jh["encoder"], JaxASR) else ((hidden,), {}),
    }
    return table.get(name, ((hidden,), {}))


@pytest.mark.parametrize("yaml", [YAMLS[0], YAMLS[1], YAMLS[2], YAMLS[3]])
def test_twin_yaml_builds_the_jax_models(yaml, tmp_path):
    """At a small width, cut alike in both YAMLs: the JAX modules'
    variables (zeros in flax's shapes, through ``jax.eval_shape``) load into
    the twin's ``modules`` through ``load_modules``, every key used, and
    the parameter counts agree (the BEST-RQ quantiser's buffers
    included)."""
    over = {"data_folder": str(tmp_path), "output_folder": str(tmp_path)}
    jh = jax_load(_small_text(ROOT / yaml), over)
    th = load_hyperpyyaml(_small_text(PORT / yaml), dict(over, device="cpu"))
    tree = {}
    for name in jh["modules"]:
        args, kwargs = _example_inputs(name, jh)
        shapes = jax.eval_shape(lambda: jh[name].init(KEY, *args, **kwargs))
        tree[name] = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    load_modules(th["modules"], tree)
    n_jax = sum(np.prod(a.shape) for a in jax.tree_util.tree_leaves(tree))
    n_port = sum(t.numel() for m in th["modules"].values()
                 for t in m.state_dict().values())
    assert n_port == n_jax > 0


# -- one step of each objective against the JAX recipes ----------------------

class JaxSelf:
    """What a JAX recipe's ``compute_forward``/``compute_objectives``
    read of their Brain."""

    module_apply = JaxBrain.module_apply
    merge_state = staticmethod(JaxBrain.merge_state)

    def __init__(self, modules, hparams):
        self.modules = SimpleNamespace(**modules)
        self.hparams = SimpleNamespace(**hparams)


def _pair(jmods, tmods, examples):
    """Weights drawn with numpy for each JAX module at its example input,
    loaded into the port's modules: the JAX parameter tree."""
    params = {}
    for i, (name, jm) in enumerate(jmods.items()):
        args, kwargs = examples[name]
        params[name] = draw_variables(jm, *args, seed=30 + i,
                                      **kwargs)["params"]
    load_modules(tmods, params)
    return params


def _grads_close(tmods, jgrads, rtol):
    """Every parameter's gradient against JAX's, within ``rtol`` of
    the largest magnitude of its tensor."""
    ref = load_modules(copy.deepcopy(tmods), jax.tree_util.tree_map(
        np.asarray, jgrads))
    for name, module in tmods.items():
        for (pname, p), (_, q) in zip(module.named_parameters(),
                                      ref[name].named_parameters()):
            scale = max(float(q.detach().abs().max()), 1e-6)
            # no gradient reaches it (the quantiser's projection behind the
            # targets' stop-gradient): JAX's is zeros
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            np.testing.assert_allclose(
                grad.numpy(), q.detach().numpy(),
                atol=max(rtol * scale, GRAD_FLOOR),
                err_msg=f"{name}.{pname}")


def _w2v_case():
    B, wav = 2, 0.3 * np.random.default_rng(40).standard_normal(
        (2, 8000)).astype(np.float32)
    T = 398
    jmods = {"extractor": jw2v.W2VLatentExtractor(**EXT),
             "quantizer": jw2v.W2VTargetQuantiser(16, 8, 4, 2),
             "latent_proj": JaxLinear(32),
             "encoder": JaxEncoder(num_layers=2, nhead=2, d_ffn=32,
                                   d_model=32, normalize_before=True),
             "pred_head": JaxLinear(8)}
    tmods = {"extractor": tw2v.W2VLatentExtractor(**EXT, device="cpu"),
             "quantizer": tw2v.W2VTargetQuantiser(16, 8, 4, 2, device="cpu"),
             "latent_proj": Linear(32, input_size=16, device="cpu"),
             "encoder": TransformerEncoder(2, 2, 32, 32,
                                           normalize_before=True,
                                           device="cpu"),
             "pred_head": Linear(8, input_size=32, device="cpu")}
    lat, x32 = jnp.zeros((B, T, 16)), jnp.zeros((B, T, 32))
    examples = {"extractor": ((jnp.asarray(wav),), {}),
                "quantizer": ((lat,), {"train": False}),
                "latent_proj": ((lat,), {}), "encoder": ((x32,), {}),
                "pred_head": ((x32,), {})}
    hp = dict(mask_prob=0.065, mask_length=10, num_negatives=8,
              temperature=0.1, diversity_weight=0.1, quantiser_vars=4,
              quantiser_groups=2)
    draws = {"randint": [((B, 2), T - 10), ((8, B, T), T - 1)],
             "normal": [(B, T, 16)], "uniform": [(B * T * 2, 4)]}
    return (f"{LS_W2V}/train_sb_wav2vec2.py", "SBW2V2Pretrain", jmods, tmods,
            examples, hp, draws, wav, {})


def _brq_case():
    B, T, n_mels = 2, 51, 16
    wav = 0.3 * np.random.default_rng(41).standard_normal(
        (B, 8000)).astype(np.float32)
    front = dict(num_blocks=2, out_channels=(8, 8), kernel_sizes=(3, 3),
                 strides=(2, 2), dropout=0.0)
    asr = dict(tgt_vocab=1, d_model=32, nhead=2, num_encoder_layers=1,
               num_decoder_layers=0, d_ffn=32, encoder_module="conformer",
               kernel_size=7, dropout=0.0)
    jmods = {"quantizer": JaxRPQ(n_mels, cb_dim=8, cb_vocab=64),
             "frontend": JaxFrontEnd(**front),
             "encoder": JaxASR(input_size=32, **asr),
             "head": JaxLinear(64)}
    tmods = {"quantizer": RandomProjectionQuantizer(n_mels, 8, 64,
                                                    device="cpu"),
             "frontend": ConvolutionFrontEnd(**front, device="cpu"),
             "encoder": TransformerASR(input_size=32, device="cpu", **asr),
             "head": Linear(64, input_size=32, device="cpu")}
    feats = jnp.zeros((B, T, n_mels))
    examples = {"quantizer": ((feats,), {}),
                "frontend": ((feats,), {"train": False}),
                "encoder": ((jnp.zeros((B, 13, 32)),), {"method": "encode"}),
                "head": ((jnp.zeros((B, 13, 32)),), {})}
    hp = dict(mask_prob=0.15, mask_length=4)
    jhp = dict(hp, compute_features=jfeatures.Fbank(n_mels=n_mels),
               normalize=jprocessing.InputNormalization(norm_type="sentence"))
    thp = dict(hp, compute_features=Fbank(n_mels=n_mels, device="cpu"),
               normalize=InputNormalization(norm_type="sentence"))
    draws = {"randint": [((B, 1), T - 4)], "normal": [(B, T, n_mels)],
             "uniform": []}
    return (f"{LS_BRQ}/train.py", "BestRQ", jmods, tmods, examples,
            (jhp, thp), draws, wav, {})


def _ctc_case():
    B, T = 2, 398
    wav = 0.3 * np.random.default_rng(42).standard_normal(
        (B, 8000)).astype(np.float32)
    jmods = {"extractor": jw2v.W2VLatentExtractor(**EXT),
             "latent_proj": JaxLinear(32),
             "encoder": JaxEncoder(num_layers=2, nhead=2, d_ffn=32,
                                   d_model=32, normalize_before=True),
             "ctc_head": JaxLinear(8)}
    tmods = {"extractor": tw2v.W2VLatentExtractor(**EXT, device="cpu"),
             "latent_proj": Linear(32, input_size=16, device="cpu"),
             "encoder": TransformerEncoder(2, 2, 32, 32,
                                           normalize_before=True,
                                           device="cpu"),
             "ctc_head": Linear(8, input_size=32, device="cpu")}
    x32 = jnp.zeros((B, T, 32))
    examples = {"extractor": ((jnp.asarray(wav),), {}),
                "latent_proj": ((jnp.zeros((B, T, 16)),), {}),
                "encoder": ((x32,), {}), "ctc_head": ((x32,), {})}
    chars = np.array([[3, 5, 1, 7, 2], [4, 4, 6, 0, 0]], np.int32)
    extra = {"char_encoded": (chars, np.array([1.0, 0.6], np.float32))}
    return (f"{LS_CTC}/train_with_wav2vec.py", "W2VCTC", jmods, tmods,
            examples, dict(blank_index=0), {"randint": [], "normal": [],
                                            "uniform": []}, wav, extra)


STEP_CASES = {"wav2vec2": _w2v_case, "bestrq": _brq_case,
              "wav2vec_ctc": _ctc_case}
PORT_BRAINS = {
    "SBW2V2Pretrain": lambda: importlib.import_module(
        "speechbrain_tpu_torch." + LS_W2V.replace("/", ".")
        + ".train_sb_wav2vec2").SBW2V2Pretrain,
    "BestRQ": lambda: importlib.import_module(
        "speechbrain_tpu_torch." + LS_BRQ.replace("/", ".") + ".train").BestRQ,
    "W2VCTC": lambda: ft_w2v.W2VCTC,
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_matches_the_jax_recipe(case, monkeypatch):
    """One training forward and backward on the same weights and draws:
    the port's Brain against the JAX script's ``compute_forward`` and
    ``compute_objectives`` under ``jax.value_and_grad`` (dropout 0)."""
    script, cls, jmods, tmods, examples, hp, spec, wav, extra = \
        STEP_CASES[case]()
    jhp, thp = hp if isinstance(hp, tuple) else (hp, hp)
    params = _pair(jmods, tmods, examples)
    draws = SameDraws(monkeypatch)
    for i, (shape, high) in enumerate(spec["randint"]):
        draws.add_randint(shape, high, seed=50 + i)
    for shape in spec["normal"]:
        draws.add_normal(shape, seed=60)
    for shape in spec["uniform"]:
        draws.add_uniform(shape, seed=70)
    draws.install()
    lens = np.array([1.0, 0.75], np.float32)
    jbatch = {"sig": (jnp.asarray(wav), jnp.asarray(lens)),
              **{k: tuple(map(jnp.asarray, v)) for k, v in extra.items()}}
    jscript = getattr(_load_script(script), cls)
    jself = JaxSelf(jmods, jhp)
    if hasattr(jscript, "_downsample"):  # W2VCTC's (no downsampler here)
        jself._downsample = jscript._downsample.__get__(jself)

    def jloss(p):
        preds, _ = jscript.compute_forward(jself, p, {}, jbatch,
                                           jsb.Stage.TRAIN, KEY)
        out = jscript.compute_objectives(jself, preds, jbatch,
                                         jsb.Stage.TRAIN)
        return (out[0], out[1]) if isinstance(out, tuple) else (out, {})

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    brain = PORT_BRAINS[cls]()(modules=tmods, hparams=thp,
                               run_opts={"device": "cpu"})
    brain.modules.train()
    tbatch = {"sig": (torch.from_numpy(wav), torch.from_numpy(lens)),
              **{k: tuple(map(torch.from_numpy, v))
                 for k, v in extra.items()}}
    loss, metrics = brain._objectives(
        brain.compute_forward(tbatch, Stage.TRAIN), tbatch, Stage.TRAIN)
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    for key, value in jmetrics.items():
        assert float(metrics[key]) == pytest.approx(float(value), abs=1e-6)
    _grads_close(brain.modules, jgrads, GRAD_RTOL[case])


# -- the fine-tuning chain (ROADMAP C53, C54) ----------------------------------

def _bestrq_ctc_yaml(package_root, tmp_path, pretrained):
    text = _small_text(package_root / LS_CTC / "hparams"
                       / "train_with_bestrq.yaml")
    over = {"data_folder": str(tmp_path / "data"),
            "output_folder": str(tmp_path / "out"),
            "pretrained_folder": pretrained}
    if package_root == PORT:
        return load_hyperpyyaml(text, dict(over, device="cpu"))
    return jax_load(text, over)


def _export(tmp_path):
    """A BEST-RQ pretraining's export at the small width: the port's
    front end and Conformer with regular attention, written as
    ``frontend.ckpt`` and ``encoder.ckpt``."""
    brq = load_hyperpyyaml(_small_text(PORT / LS_BRQ / "hparams/bestrq.yaml"),
                           {"data_folder": str(tmp_path),
                            "output_folder": str(tmp_path / "brq"),
                            "device": "cpu", "seed": 5})
    folder = tmp_path / "export"
    folder.mkdir()
    for name in ("frontend", "encoder"):
        torch.save(brq[name].state_dict(), folder / f"{name}.ckpt")
    return brq, folder


def test_c53_jax_fine_tuning_never_pours_the_pretrained_weights(tmp_path):
    """The JAX script collects ``frontend.ckpt`` and ``encoder.ckpt`` and
    never loads them: its Brain's parameters are the fresh init it draws
    without a ``pretrained_folder``, bit for bit. Pointed at a pretraining's
    save folder (checkpoint folders only), its collection raises. The
    port's ``pour_pretrained`` loads every tensor of both files, and leaves
    only the relative-position tensors at their init (C54)."""
    brq, folder = _export(tmp_path)
    jscript = _load_script(f"{LS_CTC}/train_with_bestrq.py")
    from speechbrain_tpu.utils.parameter_transfer import Pretrainer

    batch = {"sig": (jnp.zeros((1, 8000)), jnp.ones((1,)))}
    inits = []
    for pretrained in (str(folder), None):
        jh = _bestrq_ctc_yaml(ROOT, tmp_path, pretrained)
        brain = jscript.BestRQCTC(modules=jh["modules"], hparams=jh,
                                  run_opts={"seed": 1986})
        # the script's init_forward compiled as one program (op by op it
        # takes about 15 s on the CPU)
        brain.init_forward = jax.jit(jscript.BestRQCTC.init_forward.__get__(
            brain))
        if jh.get("pretrained_folder"):
            # the script's own block (train_with_bestrq.py:185-196)
            Pretrainer(
                collect_in=jh["save_folder"],
                loadables={"frontend": jh["frontend"],
                           "encoder": jh["encoder"]},
                paths={"frontend": f"{jh['pretrained_folder']}/frontend.ckpt",
                       "encoder": f"{jh['pretrained_folder']}/encoder.ckpt"},
            ).collect_files()
            assert (Path(jh["save_folder"]) / "encoder.ckpt").exists()
        brain.init_params(batch)
        inits.append(jax.tree_util.tree_map(np.asarray, brain.params))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, inits[0], inits[1]))
    (tmp_path / "save" / "CKPT+x").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        Pretrainer(collect_in=str(tmp_path / "c"),
                   loadables={"frontend": None},
                   paths={"frontend": f"{tmp_path / 'save'}/frontend.ckpt"},
                   ).collect_files()
    th = _bestrq_ctc_yaml(PORT, tmp_path / "port", str(folder))
    init = {k: v.clone() for k, v in th["encoder"].state_dict().items()}
    fresh = ft_brq.pour_pretrained(th)
    layers = len(th["encoder"].encoder.layers)
    assert sorted(fresh) == sorted(
        f"encoder.encoder.layers.{i}.attn.{n}" for i in range(layers)
        for n in ("pos_bias_u", "pos_bias_v", "pos_proj.weight"))
    for name in ("frontend", "encoder"):
        poured = th[name].state_dict()
        for key, value in brq[name].state_dict().items():
            assert torch.equal(poured[key], value), (name, key)
    for name in fresh:
        key = name[len("encoder."):]
        assert torch.equal(th["encoder"].state_dict()[key], init[key])


def _small_yaml_file(folder, yaml, tmp_path):
    path = tmp_path / yaml
    path.write_text(_small_text(PORT / folder / "hparams" / yaml))
    return str(path)


def test_bestrq_chain_through_the_clis(tmp_path):
    """The BEST-RQ twin's CLI (one batch, the valid stage, the export) and
    ``train_with_bestrq``'s from that export, in process at the small
    width, on the LibriSpeech synthetic corpus."""
    brq = importlib.import_module(
        "speechbrain_tpu_torch." + LS_BRQ.replace("/", ".") + ".train")
    flags = ["--device=cpu", "--debug", "--debug_batches=1",
             "--debug_epochs=1", "--noprogressbar",
             f"--data_folder={tmp_path / 'data'}"]
    brain, _ = _main(brq.main, [
        _small_yaml_file(LS_BRQ, "bestrq.yaml", tmp_path),
        f"--output_folder={tmp_path / 'brq'}", *flags])
    save = tmp_path / "brq" / "save"
    assert sorted(p.name for p in save.glob("*.ckpt")) == [
        "encoder.ckpt", "frontend.ckpt"]
    assert list(brain.modules.quantizer.parameters()) == []
    ft, _ = _main(ft_brq.main, [
        _small_yaml_file(LS_CTC, "train_with_bestrq.yaml", tmp_path),
        f"--output_folder={tmp_path / 'ft'}", f"--pretrained_folder={save}",
        *flags])
    log = (tmp_path / "ft" / "train_log.txt").read_text()
    assert "lr_encoder: 1.00e-04" in log
    assert {g["name"] for g in ft.optimizer.param_groups} == {"encoder",
                                                              "main"}


# -- the card's path, on the CPU ----------------------------------------------

def test_run_ssl_path_on_the_cpu(tmp_path, monkeypatch):
    """The card's ssl_path at a cut width on the CPU (three of the other
    twins): every phase's checks hold, B3's plain version is counted once
    a BEST-RQ batch and a served call, as the path predicts, and no other
    kernel launches."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "gpu_name_power_limit", lambda: "cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lines.append)
    monkeypatch.setattr(chip_smoke, "SSL_YAML_EDITS", SMALL)
    monkeypatch.setattr(chip_smoke, "SSL_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "SSL_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "SSL_SERVE_REPEATS", 1)
    monkeypatch.setattr(chip_smoke, "SSL_CORPUS", dict(
        chip_smoke.SSL_CORPUS, seconds=(1.0, 1.5), valid_seconds=1.5))
    monkeypatch.setattr(chip_smoke, "SSL_B3_SHAPES", ((2, 16000, 80),))
    monkeypatch.setattr(chip_smoke, "SSL_TWINS", chip_smoke.SSL_TWINS[:4])
    reference = mel_frontend.fused_fbank_reference

    def counted(wav, *args):
        refuse_autograd("fused_fbank_reference", wav)
        mel_frontend.launches += 1
        return reference(wav, *args)

    monkeypatch.setattr(mel_frontend, "fused_fbank_reference", counted)
    handlers = list(logging.getLogger().handlers)
    try:
        launches, b3_err = chip_smoke.run_ssl_path(str(tmp_path / "ssl"),
                                                   device="cpu")
    finally:
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)
    by_phase = {line["phase"]: line for line in lines}
    assert list(by_phase) == [
        "ssl_b3_check", "ssl_path/wav2vec2_pretrain/fp32",
        "ssl_path/wav2vec2_pretrain/bf16", "ssl_path/bestrq_pretrain",
        "ssl_path/train_with_bestrq", "ssl_path/train_with_wav2vec",
        "ssl_path/Libri-Light/wav2vec2.yaml",
        "ssl_path/Libri-Light/bestrq.yaml",
        "ssl_path/CommonVoice/train_hf_wav2vec2.yaml",
        "ssl_path/DVoice/train_with_wav2vec2.yaml", "ssl_path_summary"]
    for phase, line in by_phase.items():
        assert line.get("ok", True), (phase, line)
    summary = by_phase["ssl_path_summary"]
    assert launches["fused_fbank"] == summary["predicted_b3"] > 0
    assert sum(launches.values()) == launches["fused_fbank"]
    assert list(b3_err) == ["2x16000@80"]
    w2v = by_phase["ssl_path/wav2vec2_pretrain/fp32"]
    assert w2v["recovered_bitwise"] and len(w2v["prob_perplexity"]) == 1
    ft = by_phase["ssl_path/train_with_bestrq"]
    assert ft["left_at_init"] == 3 and ft["serve"]["shape"] == [2, 24000]
