"""The audio classifiers against the JAX package at a tiny width: ``Cnn14``
(with and without ``return_reps``), the PIQ ``Conv2dEncoder_v2``,
``ViTEncoder`` (tokens and attention maps) and the six focal-modulation
classes, each in evaluation mode and in one training-mode step (the
output, every parameter's gradient of the mean square of the output, and
the running statistics after it); FocalNet at an even and an odd length
(XLA's ``SAME`` padding of a strided stage projection); ROADMAP C42 (JAX's
``AudioClassifier`` raises ``TypeError`` on each ESC50 encoder; the
port's serves the encoder with the recipe's pooling); and
``EndToEndSLU`` against JAX's over the same CRDNN, token for token, with
C43 (JAX's interface cannot call a flax encoder named in its hparams).

Weights are drawn with numpy into the shapes of flax's variables
(``jax.eval_shape`` of its init) and carried over by ``utils/jax_bridge``.
Tolerance: 1e-5 relative L2 in float32 for outputs and running
statistics, 1e-4 for the whole gradient (``GRAD_RTOL``); tokens equal."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.dataio.encoder import CategoricalEncoder as JaxEncoder
from speechbrain_tpu.inference.classifiers import (
    AudioClassifier as JaxAudioClassifier,
)
from speechbrain_tpu.inference.SLU import EndToEndSLU as JaxEndToEndSLU
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models import PIQ as jpiq
from speechbrain_tpu.lobes.models import Cnn14 as jcnn14
from speechbrain_tpu.lobes.models import focalnet as jfocal
from speechbrain_tpu.lobes.models import vit as jvit
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JaxCRDNN
from speechbrain_tpu.nnet.embedding import Embedding as JaxEmbedding
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.RNN import AttentionalRNNDecoder as JaxDecoder
from speechbrain_tpu.processing.features import (
    InputNormalization as JaxNorm,
)
from speechbrain_tpu_torch.dataio.encoder import CategoricalEncoder
from speechbrain_tpu_torch.inference.classifiers import AudioClassifier
from speechbrain_tpu_torch.inference.SLU import EndToEndSLU
from speechbrain_tpu_torch.lobes import features as tfeatures
from speechbrain_tpu_torch.lobes.models import PIQ as tpiq
from speechbrain_tpu_torch.lobes.models import Cnn14 as tcnn14
from speechbrain_tpu_torch.lobes.models import focalnet as tfocal
from speechbrain_tpu_torch.lobes.models import vit as tvit
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet.containers import LengthsCapableSequential
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.RNN import AttentionalRNNDecoder
from speechbrain_tpu_torch.processing.features import InputNormalization
from speechbrain_tpu_torch.recipes.ESC50.classification.train import (
    PooledEncoder,
)
from speechbrain_tpu_torch.recipes.LibriSpeech.ASR.seq2seq.train import (
    RNNSearchDecoder,
)
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _jax, _t, _x, draw_variables, japply

RTOL = 1e-5
# the whole gradient: a training-mode BatchNorm's float32 E[x^2] - E[x]^2
# in the backward puts Cnn14's 1.3e-5 apart (a bias before a BatchNorm,
# whose gradient is zero but for rounding, is not held alone)
GRAD_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
FOCAL = dict(focal_window=3, focal_level=2, focal_factor=2)

# name: (JAX module, port module, input shape); the port's constructors
# take the input widths flax infers
CASES = {
    "cnn14": (jcnn14.Cnn14(mel_bins=32, emb_dim=24, base_channels=4),
              lambda: tcnn14.Cnn14(mel_bins=32, emb_dim=24, base_channels=4,
                                   device="cpu"),
              (3, 70, 32)),
    "cnn14_reps": (
        jcnn14.Cnn14(mel_bins=32, emb_dim=24, base_channels=4,
                     return_reps=True),
        lambda: tcnn14.Cnn14(mel_bins=32, emb_dim=24, base_channels=4,
                             return_reps=True, device="cpu"),
        (3, 70, 32)),
    "conv2d_encoder_v2": (jpiq.Conv2dEncoder_v2(dim=8),
                          lambda: tpiq.Conv2dEncoder_v2(dim=8, device="cpu"),
                          (3, 37, 35)),
    "conv2d_encoder_v2_reps": (
        jpiq.Conv2dEncoder_v2(dim=8, return_reps=True),
        lambda: tpiq.Conv2dEncoder_v2(dim=8, return_reps=True,
                                      device="cpu"),
        (3, 37, 35)),
    "vit": (jvit.ViTEncoder(d_model=16, nhead=4, num_layers=2, d_ffn=32,
                            patch_size=(8, 8), max_patches=64),
            lambda: tvit.ViTEncoder(d_model=16, nhead=4, num_layers=2,
                                    d_ffn=32, patch_size=(8, 8),
                                    max_patches=64, device="cpu"),
            (2, 37, 24)),
    "vit_reps": (jvit.ViTEncoder(d_model=16, nhead=4, num_layers=1, d_ffn=32,
                                 patch_size=(8, 8), max_patches=64,
                                 return_reps=True),
                 lambda: tvit.ViTEncoder(d_model=16, nhead=4, num_layers=1,
                                         d_ffn=32, patch_size=(8, 8),
                                         max_patches=64, return_reps=True,
                                         device="cpu"),
                 (2, 37, 24)),
    "focal_modulation": (jfocal.FocalModulation1d(dim=12, **FOCAL),
                         lambda: tfocal.FocalModulation1d(12, device="cpu",
                                                          **FOCAL),
                         (2, 11, 12)),
    "focal_modulation_causal": (
        jfocal.FocalModulation1d(dim=12, causal=True,
                                 normalize_modulator=True, **FOCAL),
        lambda: tfocal.FocalModulation1d(12, causal=True,
                                         normalize_modulator=True,
                                         device="cpu", **FOCAL),
        (2, 11, 12)),
    "focal_block_layerscale": (
        jfocal.FocalBlock1d(dim=12, use_layerscale=True,
                            layerscale_init=0.5, **FOCAL),
        lambda: tfocal.FocalBlock1d(12, use_layerscale=True,
                                    layerscale_init=0.5, device="cpu",
                                    **FOCAL),
        (2, 11, 12)),
    "focal_block_post_norm": (
        jfocal.FocalBlock1d(dim=12, use_post_norm=True, mlp_ratio=2.0,
                            **FOCAL),
        lambda: tfocal.FocalBlock1d(12, use_post_norm=True, mlp_ratio=2.0,
                                    device="cpu", **FOCAL),
        (2, 11, 12)),
    "focal_stack": (
        jfocal._FocalStack(hidden_dims=(12, 8), scale_factors=(3, 1),
                           upsample=False, **FOCAL),
        lambda: tfocal._FocalStack(10, (12, 8), (3, 1), False, device="cpu",
                                   **FOCAL),
        (2, 23, 10)),
    "focal_encoder": (
        jfocal.FocalEncoder(input_dim=10, output_dim=6, hidden_dims=(12, 8),
                            downscale_factors=(2, 1), use_layerscale=True,
                            **FOCAL),
        lambda: tfocal.FocalEncoder(10, 6, (12, 8), (2, 1),
                                    use_layerscale=True, device="cpu",
                                    **FOCAL),
        (2, 13, 10)),
    "focal_decoder": (
        jfocal.FocalDecoder(input_dim=6, output_dim=10, hidden_dims=(8, 12),
                            upscale_factors=(2, 1), **FOCAL),
        lambda: tfocal.FocalDecoder(6, 10, (8, 12), (2, 1), device="cpu",
                                    **FOCAL),
        (2, 7, 6)),
    # the ESC50 YAML's k = 2 stage projections at an even and an odd length
    "focalnet_even": (
        jfocal.FocalNetEncoder(hidden_dims=(12, 8), downscale_factors=(2, 2)),
        lambda: tfocal.FocalNetEncoder(10, (12, 8), (2, 2), device="cpu"),
        (2, 20, 10)),
    "focalnet_odd": (
        jfocal.FocalNetEncoder(hidden_dims=(12, 8), downscale_factors=(2, 2),
                               return_reps=True),
        lambda: tfocal.FocalNetEncoder(10, (12, 8), (2, 2),
                                       return_reps=True, device="cpu"),
        (2, 21, 10)),
}
# JAX modules whose __call__ takes no ``train``
NO_TRAIN_ARG = ("focal_modulation", "focal_modulation_causal")


def _leaves(out):
    """The arrays of an output: a tensor, or a tuple of a tensor and a
    list of maps (or attention maps)."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    return [out]


def _rel(a, b, rtol=RTOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.linalg.norm(a - b)
    assert err <= rtol * max(np.linalg.norm(b), 1e-30), (what, err,
                                                         np.linalg.norm(b))


def _case(name):
    jm, make, shape = CASES[name]
    x = _x(shape, seed=7)
    kw = {} if name in NO_TRAIN_ARG else {"train": False}
    variables = draw_variables(jm, jnp.asarray(x), seed=3, **kw)
    tm = make()
    load(tm, variables)
    return jm, tm, x, variables


@pytest.mark.parametrize("name", list(CASES))
def test_module_in_evaluation_mode_matches_jax(name):
    jm, tm, x, variables = _case(name)
    kw = {} if name in NO_TRAIN_ARG else {"train": False}
    ref = jax.jit(lambda v, a: jm.apply(v, a, **kw))(_jax(variables),
                                                     jnp.asarray(x))
    with torch.no_grad():
        out = tm.eval()(_t(x))
    ours, theirs = _leaves(out), _leaves(ref)
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        _rel(a, b, what=f"{name} output {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_training_step_matches_jax(name):
    """One training-mode forward and backward of the mean square of the
    (first) output: the output, every parameter's gradient, and the
    running statistics after it."""
    jm, tm, x, variables = _case(name)
    params = _jax(variables["params"])
    rest = {k: _jax(v) for k, v in variables.items() if k != "params"}
    kw = {} if name in NO_TRAIN_ARG else {"train": True}
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def loss_fn(p):
        out = jm.apply({"params": p, **rest}, jnp.asarray(x),
                       mutable=mutable, **kw)
        out, new = out if mutable else (out, {})
        first = _leaves(out)[0]
        return jnp.mean(first ** 2), (first, new)

    (jloss, (jout, jnew)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.train()
    first = _leaves(tm(_t(x)))[0]
    loss = (first ** 2).mean()
    loss.backward()
    _rel(first, jout, what="output")
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    ref = copy.deepcopy(tm)
    load(ref, {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    grads = dict(ref.named_parameters())
    ours = [p.grad.reshape(-1) for _, p in tm.named_parameters()]
    theirs = [grads[n].detach().reshape(-1) for n, _ in tm.named_parameters()]
    _rel(torch.cat(ours), torch.cat(theirs).numpy(), rtol=GRAD_RTOL,
         what=f"{name} grads")
    if mutable:
        stats = copy.deepcopy(tm)
        load(stats, {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map(
                         np.asarray, jnew["batch_stats"])})
        theirs = dict(stats.named_buffers())
        n = 0
        for bname, buf in tm.named_buffers():
            _rel(buf, theirs[bname].numpy(), what=f"{name} stat {bname}")
            n += 1
        assert n > 0


@pytest.mark.parametrize("length,frames", [(20, 5), (21, 6)])
def test_focalnet_keeps_xla_same_lengths(length, frames):
    """Two stride-2 stage projections: ceil(ceil(L / 2) / 2) frames, as
    XLA's ``SAME`` gives (a kernel of 4 pads 1 in front and 2 behind at
    20 frames, 1 and 1 at 21)."""
    assert tfocal.xla_same_pads(20, 4, 2) == (1, 1)
    assert tfocal.xla_same_pads(21, 4, 2) == (1, 2)
    enc = tfocal.FocalNetEncoder(10, (12, 8), (2, 2), device="cpu")
    jenc = jfocal.FocalNetEncoder(hidden_dims=(12, 8),
                                  downscale_factors=(2, 2))
    x = _x((1, length, 10))
    with torch.no_grad():
        assert enc.eval()(_t(x)).shape[1] == frames
    out, _ = jax.eval_shape(lambda a: jenc.init_with_output(KEY, a),
                            jnp.asarray(x))
    assert out.shape[1] == frames


# -- C42: the classification interface and the recipe's encoders ------------

ESC50_ENCODERS = ("cnn14", "conv2d_encoder_v2", "vit", "focalnet_even")


def _classifier_pair(name):
    """JAX's and the port's ``AudioClassifier`` over one encoder and a
    linear head, the same weights and running statistics. JAX's
    embedding model is the encoder itself, as its recipe trains and
    names it; the port's is the recipe's ``PooledEncoder`` around it."""
    jm, make, shape = CASES[name]
    n_mels = shape[2]
    wav = 0.3 * _x((3, 160 * (shape[1] - 1)), seed=6)
    jfbank = jfeatures.Fbank(n_mels=n_mels)
    feats = jfbank(jnp.asarray(wav))
    ev = draw_variables(jm, feats, train=False, seed=3)
    emb = japply(jm, ev, feats, train=False)
    emb = emb[0] if isinstance(emb, tuple) else emb
    width = emb.shape[-1]
    jclf = JaxLinear(n_neurons=5)
    cv = draw_variables(jclf, jnp.ones((3, 1, width)), seed=2)
    labels = ["dog", "rain", "siren", "clock", "cat"]
    jenc, tenc = JaxEncoder(), CategoricalEncoder()
    for enc in (jenc, tenc):
        enc.update_from_iterable(labels)
    tm = make()
    load(tm, ev)
    tclf = Linear(5, width, device="cpu")
    load(tclf, cv)
    jax_kw = dict(params={"embedding_model": ev["params"],
                          "classifier": cv["params"]},
                  model_state={"batch_stats": {
                      "embedding_model": ev.get("batch_stats", {})}})
    j = JaxAudioClassifier(
        modules={"embedding_model": jm, "classifier": jclf},
        hparams={"compute_features": jfbank, "label_encoder": jenc},
        **jax_kw)
    t = AudioClassifier(
        modules={"embedding_model": PooledEncoder(tm), "classifier": tclf},
        hparams={"compute_features": tfeatures.Fbank(n_mels=n_mels,
                                                     device="cpu"),
                 "label_encoder": tenc},
        run_opts={"device": "cpu"})
    return wav, j, t, (jm, ev, jclf, cv, feats)


@pytest.mark.parametrize("name", ESC50_ENCODERS)
def test_c42_jax_audio_classifier_raises_and_the_port_serves(name):
    """JAX's ``encode_batch`` hands ``lengths=`` to every embedding
    model; none of the ESC50 encoders takes it. The port's interface
    serves the encoder with the recipe's pooling: its output equals the
    JAX recipe's computation (the encoder, the pooling of its
    ``compute_forward``, the head) on the same features."""
    wav, j, t, (jm, ev, jclf, cv, feats) = _classifier_pair(name)
    lens = np.array([1.0, 0.9, 0.7], np.float32)
    with pytest.raises(TypeError, match="lengths"):
        j.classify_batch(jnp.asarray(wav), jnp.asarray(lens))
    emb = japply(jm, ev, feats, train=False)
    emb = emb[0] if isinstance(emb, tuple) else emb
    pooled = (jnp.mean(emb, axis=(1, 2))[:, None] if emb.ndim == 4
              else jnp.mean(emb, axis=1, keepdims=True))
    ref = jclf.apply(_jax(cv), pooled)[:, 0]
    out_prob, score, index, labels = t.classify_batch(_t(wav), _t(lens))
    _rel(out_prob, ref, what=name)
    np.testing.assert_array_equal(index.numpy(), np.argmax(ref, -1))
    assert labels == [t.hparams.label_encoder.decode_ind(int(i))
                      for i in index]


# -- EndToEndSLU ------------------------------------------------------------

SLU_CRDNN = dict(cnn_blocks=1, cnn_channels=(4,),
                 inter_layer_pooling_size=(2,), time_pooling=True,
                 time_pooling_size=4, rnn_layers=1, rnn_neurons=8,
                 dnn_blocks=1, dnn_neurons=12)
SLU_V = 9


class _Tokenizer:
    """``decode_ids`` of a character table (the interface's only call)."""

    def decode_ids(self, ids):
        return "".join("abcdefghi"[int(i)] for i in ids)


def _slu_pair():
    wav = 0.3 * _x((3, 8000), seed=9)
    lens = np.array([1.0, 0.85, 0.6], np.float32)
    jfbank, jnorm = jfeatures.Fbank(n_mels=16), JaxNorm(norm_type="sentence")
    feats = jnorm(jfbank(jnp.asarray(wav)), jnp.asarray(lens))
    jenc = JaxCRDNN(dropout=0.0, **SLU_CRDNN)
    ev = draw_variables(jenc, feats, train=False, seed=4)
    enc_out = jenc.apply(_jax(ev), feats, train=False)
    jemb = JaxEmbedding(num_embeddings=SLU_V, embedding_dim=6)
    jdec = JaxDecoder(hidden_size=10, attn_dim=6, attn_type="keyvalue")
    jlin = JaxLinear(n_neurons=SLU_V)
    tok = jnp.zeros((3, 2), jnp.int32)
    mv = draw_variables(jemb, tok, seed=5)
    e = jemb.apply(_jax(mv), tok)
    dv = draw_variables(jdec, e, enc_out, jnp.asarray(lens), seed=6)
    out = jdec.apply(_jax(dv), e, enc_out, jnp.asarray(lens))
    out = out[0] if isinstance(out, tuple) else out
    lv = draw_variables(jlin, out, seed=7)
    tenc = CRDNN(input_size=16, dropout=0.0, device="cpu", **SLU_CRDNN)
    temb = Embedding(SLU_V, 6, device="cpu")
    tdec = AttentionalRNNDecoder(hidden_size=10, attn_dim=6, input_size=6,
                                 enc_dim=12, attn_type="keyvalue",
                                 device="cpu")
    tlin = Linear(SLU_V, 10, device="cpu")
    for m, v in ((tenc, ev), (temb, mv), (tdec, dv), (tlin, lv)):
        load(m, v)
    return wav, lens, (jfbank, jnorm, jenc, ev, jemb, mv, jdec, dv, jlin,
                       lv), (tenc, temb, tdec, tlin)


SLU_SEARCH = dict(bos_index=0, eos_index=0, beam_size=3,
                  min_decode_ratio=0.0, max_decode_ratio=1.0,
                  eos_threshold=1.5)


def _jax_slu(jfbank, jnorm, jenc, ev, jemb, mv, jdec, dv, jlin, lv):
    """JAX's ``EndToEndSLU`` over plain callables built from the bound
    modules: the only way its ``slu_enc(wavs, wav_lens)`` and
    ``beam_searcher(states, lens)`` calls reach the weights (C43)."""
    from speechbrain_tpu.decoders.seq2seq import S2SRNNBeamSearcher

    def slu_enc(wavs, wav_lens):
        return jenc.apply(_jax(ev), jnorm(jfbank(wavs), wav_lens),
                          train=False)

    def step_fn(inp_tokens, memory, enc_states, enc_lens):
        emb = jemb.apply(_jax(mv), inp_tokens[:, None])[:, 0]
        out, state, attn = jdec.apply(_jax(dv), emb, memory, enc_states,
                                      enc_lens, method="forward_step")
        return (jax.nn.log_softmax(jlin.apply(_jax(lv), out), -1), state,
                attn)

    def init_fn(batch_size, enc_states, enc_lens):
        T = enc_states.shape[1]
        state = jdec.apply(_jax(dv), batch_size, T, method="init_state")
        mask = (jnp.arange(T)[None, :]
                < jnp.round(enc_lens * T)[:, None]).astype(jnp.float32)
        state["prev_attn"] = mask / jnp.maximum(mask.sum(-1, keepdims=True),
                                                1.0)
        return state

    searcher = S2SRNNBeamSearcher(step_fn=step_fn, init_fn=init_fn,
                                  **SLU_SEARCH)
    return JaxEndToEndSLU(hparams={"tokenizer": _Tokenizer(),
                                   "slu_enc": slu_enc,
                                   "beam_searcher": searcher})


def test_end_to_end_slu_tokens_match_jax():
    wav, lens, jparts, (tenc, temb, tdec, tlin) = _slu_pair()
    j = _jax_slu(*jparts)
    jwords, jhyps = j.decode_batch(jnp.asarray(wav), jnp.asarray(lens))
    t = EndToEndSLU(hparams={
        "tokenizer": _Tokenizer(),
        "slu_enc": LengthsCapableSequential([
            tfeatures.Fbank(n_mels=16, device="cpu"),
            InputNormalization(norm_type="sentence"), tenc]),
        "beam_searcher": RNNSearchDecoder(temb, tdec, tlin, **SLU_SEARCH)},
        run_opts={"device": "cpu"})
    words, hyps = t.decode_batch(_t(wav), _t(lens))
    assert [list(map(int, h)) for h in hyps] == \
        [list(map(int, h)) for h in jhyps]
    assert words == jwords
    assert any(len(h) for h in hyps)


def test_c43_jax_slu_cannot_call_a_flax_encoder_in_its_hparams():
    """A YAML names modules, not closures: given the flax CRDNN as
    ``slu_enc``, JAX's ``encode_batch`` calls it outside ``apply`` and
    raises; the parameters its ``from_hparams`` would load never reach
    it."""
    wav, lens, jparts, _ = _slu_pair()
    j = JaxEndToEndSLU(hparams={"tokenizer": _Tokenizer(),
                                "slu_enc": jparts[2]})
    with pytest.raises(Exception):
        j.encode_batch(jnp.asarray(wav), jnp.asarray(lens))
