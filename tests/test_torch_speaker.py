"""The speaker and classification family against the JAX package at a
small size: the AAM losses (values and gradients against ``jax.grad``),
``classification_error``, the four poolings, ECAPA-TDNN, the x-vector and
the ResNet (evaluation mode, and training mode with their running
statistics, at relative lengths below 1), both ``Classifier``s and the
``Discriminator``, ``CyclicLRScheduler``, ``SpeedPerturb`` a branch at a
time, LDA, PLDA and ``fast_PLDA_scoring``, the LEAF front end's parts
(``GaborConv1d``, the EMA, ``PCEN``, ``Leaf``), and the ``EncoderClassifier``
and ``SpeakerRecognition`` interfaces against JAX's on the same bridged
weights. Weights are drawn with numpy into the shapes of flax's variables
(``jax.eval_shape`` of its init) and carried over by ``utils/jax_bridge``.

Tolerances: 1e-5 absolute (float32 on both sides, sums in another order)
for features, poolings and module outputs; 1e-4 relative for embeddings
and losses; labels and decisions equal; the numpy back end (PLDA, LDA)
exactly equal, the same code on the same inputs."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.augment.time_domain import SpeedPerturb as JaxSpeed
from speechbrain_tpu.dataio.encoder import CategoricalEncoder as JaxEncoder
from speechbrain_tpu.inference.classifiers import (
    EncoderClassifier as JaxEncoderClassifier,
)
from speechbrain_tpu.inference.speaker import (
    SpeakerRecognition as JaxSpeakerRecognition,
)
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models import ECAPA_TDNN as jecapa
from speechbrain_tpu.lobes.models import ResNet as jresnet
from speechbrain_tpu.lobes.models import Xvector as jxvector
from speechbrain_tpu.nnet import CNN as jcnn
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.nnet import normalization as jnorm
from speechbrain_tpu.nnet import pooling as jpool
from speechbrain_tpu.nnet.schedulers import CyclicLRScheduler as JaxCyclic
from speechbrain_tpu.processing import PLDA_LDA as jplda
from speechbrain_tpu_torch.augment.time_domain import SpeedPerturb
from speechbrain_tpu_torch.dataio.encoder import CategoricalEncoder
from speechbrain_tpu_torch.inference.classifiers import EncoderClassifier
from speechbrain_tpu_torch.inference.encoders import MelSpectrogramEncoder
from speechbrain_tpu_torch.inference.speaker import SpeakerRecognition
from speechbrain_tpu_torch.lobes import features as tfeatures
from speechbrain_tpu_torch.lobes.models import ECAPA_TDNN as tecapa
from speechbrain_tpu_torch.lobes.models import ResNet as tresnet
from speechbrain_tpu_torch.lobes.models import Xvector as txvector
from speechbrain_tpu_torch.nnet import CNN as tcnn
from speechbrain_tpu_torch.nnet import losses as tlosses
from speechbrain_tpu_torch.nnet import normalization as tnorm
from speechbrain_tpu_torch.nnet import pooling as tpool
from speechbrain_tpu_torch.nnet.schedulers import CyclicLRScheduler
from speechbrain_tpu_torch.processing import PLDA_LDA as tplda
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _close, _t, _x, draw_variables, japply

ATOL = 1e-5
RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
LENS = np.array([1.0, 0.8, 0.55], np.float32)
ECAPA = dict(channels=(16, 16, 16, 16, 48), attention_channels=8,
             res2net_scale=4, se_channels=8, lin_neurons=12)
RESNET = dict(channels=(4, 4, 8, 8), layers=(1, 1, 1, 1), lin_neurons=8,
              attention_channels=6)
XVECTOR = dict(tdnn_channels=(16, 16, 16, 16, 30), lin_neurons=12)


def _rel(torch_out, jax_out, rtol=RTOL):
    a = torch_out.detach().numpy()
    b = np.asarray(jax_out)
    assert np.linalg.norm(a - b) <= rtol * np.linalg.norm(b)


def _stats(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _running_stats_equal(tm, jm, variables, *args, **kwargs):
    """The port's running statistics after one training forward (already
    run on ``tm``) against flax's updated ``batch_stats``."""
    _, new = japply(jm, variables, *args, train=True,
                    mutable=["batch_stats"], **kwargs)
    ref = copy.deepcopy(tm)
    load(ref, {"params": variables["params"],
               "batch_stats": _stats(new["batch_stats"])})
    n = 0
    for (name, a), (_, b) in zip(tm.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=name)
        n += 1
    assert n > 0


# -- losses --------------------------------------------------------------

@pytest.mark.parametrize("easy", [False, True])
def test_aam_softmax_values_and_gradients_match_jax(easy):
    rng = np.random.default_rng(0)
    cos = np.tanh(rng.standard_normal((6, 9))).astype(np.float32)
    # past the clip (a cosine of 1), and the cos - mm arm
    cos[0, 0], cos[1, 1] = 1.0, -0.98
    targets = np.array([0, 1, 2, 8, 4, 2])
    onehot = np.eye(9, dtype=np.float32)[targets]
    jaam = jlosses.AdditiveAngularMargin(margin=0.2, scale=30,
                                         easy_margin=easy)
    taam = tlosses.AdditiveAngularMargin(margin=0.2, scale=30,
                                         easy_margin=easy)
    _close(taam(_t(cos), _t(onehot)), jaam(jnp.asarray(cos),
                                            jnp.asarray(onehot)))
    jloss_fn = jlosses.LogSoftmaxWrapper(jaam)
    jl, jg = jax.value_and_grad(
        lambda c: jloss_fn(c, jnp.asarray(targets)))(jnp.asarray(cos))
    c = _t(cos).requires_grad_(True)
    tl = tlosses.LogSoftmaxWrapper(taam)(c, torch.from_numpy(targets))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=RTOL)
    _close(c.grad, jg)


def test_angular_margin_wrapper_shapes_and_one_argument_loss():
    rng = np.random.default_rng(1)
    cos = np.tanh(rng.standard_normal((4, 1, 5))).astype(np.float32)
    targets = np.array([[0], [3], [4], [1]])
    for jfn, tfn in (
        (jlosses.AngularMargin(0.3, 10), tlosses.AngularMargin(0.3, 10)),
        # a loss function of the outputs alone (the TypeError fallback)
        (lambda x: 2.0 * x, lambda x: 2.0 * x),
    ):
        jl = jlosses.LogSoftmaxWrapper(jfn)(jnp.asarray(cos),
                                            jnp.asarray(targets))
        tl = tlosses.LogSoftmaxWrapper(tfn)(_t(cos), _t(targets))
        assert float(tl) == pytest.approx(float(jl), rel=RTOL)


def test_classification_error_matches_jax():
    rng = np.random.default_rng(2)
    probs = rng.standard_normal((3, 5, 4)).astype(np.float32)
    targets = rng.integers(0, 4, (3, 5))
    for p, t, lens in ((probs, targets, LENS), (probs[:, 0], targets[:, 0],
                                                None)):
        j = jlosses.classification_error(
            jnp.asarray(p), jnp.asarray(t),
            None if lens is None else jnp.asarray(lens))
        tt = tlosses.classification_error(
            _t(p), _t(t), None if lens is None else _t(lens))
        assert float(tt) == pytest.approx(float(j), abs=1e-7)


# -- poolings ------------------------------------------------------------

@pytest.mark.parametrize("lengths", [None, LENS])
def test_statistics_pooling_matches_jax(lengths):
    x = _x((3, 11, 6))
    j = jpool.StatisticsPooling().apply(
        {}, jnp.asarray(x), lengths=None if lengths is None
        else jnp.asarray(lengths))
    t = tpool.StatisticsPooling()(_t(x), None if lengths is None
                                  else _t(lengths))
    _close(t, j)


@pytest.mark.parametrize("size", [1, 3, 5])
def test_adaptive_pool_matches_jax(size):
    x = _x((2, 11, 4))
    _close(tpool.AdaptivePool(size)(_t(x)),
           jpool.AdaptivePool(size).apply({}, jnp.asarray(x)))


def test_gaussian_lowpass_pooling_matches_jax():
    x = np.abs(_x((2, 60, 5)))
    jm = jpool.GaussianLowpassPooling(kernel_size=11, stride=4)
    weights = np.array([0.01, 0.1, 0.3, 0.45, 0.9], np.float32)  # clipped
    variables = {"params": {"weights": weights}}
    tm = tpool.GaussianLowpassPooling(5, kernel_size=11, stride=4,
                                      device="cpu")
    load(tm, variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))


def test_attention_pooling_matches_jax():
    x = _x((3, 9, 7))
    jm = jpool.AttentionPooling()
    variables = draw_variables(jm, jnp.asarray(x))
    tm = tpool.AttentionPooling(7, device="cpu")
    load(tm, variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))


# -- embedding models ------------------------------------------------------

def _pair(jm, tm, x, **kwargs):
    variables = draw_variables(jm, jnp.asarray(x), train=False, **kwargs)
    load(tm, variables)
    return variables


@pytest.mark.parametrize("global_context", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_ecapa_matches_jax(train, global_context):
    x = _x((3, 40, 12))
    lens = jnp.asarray(LENS)
    jm = jecapa.ECAPA_TDNN(global_context=global_context, **ECAPA)
    tm = tecapa.ECAPA_TDNN(12, global_context=global_context, device="cpu",
                           **ECAPA)
    variables = _pair(jm, tm, x, lengths=lens)
    if not train:
        _rel(tm.eval()(_t(x), lengths=_t(LENS)),
             japply(jm, variables, jnp.asarray(x), lengths=lens,
                    train=False))
        return
    jout, _ = japply(jm, variables, jnp.asarray(x), lengths=lens,
                     train=True, mutable=["batch_stats"])
    _rel(tm.train()(_t(x), lengths=_t(LENS)), jout)
    _running_stats_equal(tm, jm, variables, jnp.asarray(x), lengths=lens)


def test_attentive_pooling_of_a_zero_length_row_is_nan_as_in_jax():
    x = _x((2, 10, 16))
    lens = np.array([1.0, 0.0], np.float32)
    jm = jecapa.AttentiveStatisticsPooling(attention_channels=4)
    tm = tecapa.AttentiveStatisticsPooling(16, 4, device="cpu").eval()
    variables = draw_variables(jm, jnp.asarray(x), lengths=jnp.asarray(lens),
                               train=False)
    load(tm, variables)
    j = np.asarray(japply(jm, variables, jnp.asarray(x),
                          lengths=jnp.asarray(lens), train=False))
    t = tm(_t(x), lengths=_t(lens)).detach().numpy()
    assert np.isnan(j[1]).all() and np.isnan(t[1]).all()
    np.testing.assert_allclose(t[0], j[0], atol=ATOL)


def test_attentive_pooling_under_autocast_takes_float32_statistics():
    x = _x((2, 10, 16))
    tm = tecapa.AttentiveStatisticsPooling(16, 4, device="cpu").eval()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = tm(_t(x).bfloat16(), lengths=_t(np.array([1.0, 0.5],
                                                         np.float32)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("lin_blocks", [0, 1])
def test_ecapa_classifier_matches_jax(lin_blocks):
    x = _x((4, 1, 12))
    jm = jecapa.Classifier(out_neurons=7, lin_blocks=lin_blocks,
                           lin_neurons=10)
    tm = tecapa.Classifier(12, 7, lin_blocks=lin_blocks, lin_neurons=10,
                           device="cpu").eval()
    variables = _pair(jm, tm, x)
    assert tm.weight.shape == (10 if lin_blocks else 12, 7)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x), train=False))


@pytest.mark.parametrize("train", [False, True])
def test_xvector_matches_jax(train):
    x = _x((3, 30, 10))
    lens = jnp.asarray(LENS)
    jm = jxvector.Xvector(**XVECTOR)
    tm = txvector.Xvector(10, device="cpu", **XVECTOR)
    variables = _pair(jm, tm, x, lengths=lens)
    tm.train(train)
    out = tm(_t(x), lengths=_t(LENS))
    jout = japply(jm, variables, jnp.asarray(x), lengths=lens, train=train,
                  **({"mutable": ["batch_stats"]} if train else {}))
    _rel(out, jout[0] if train else jout)
    if train:
        _running_stats_equal(tm, jm, variables, jnp.asarray(x), lengths=lens)


@pytest.mark.parametrize("train", [False, True])
def test_xvector_classifier_and_discriminator_match_jax(train):
    x = _x((5, 1, 12))
    for jm, tm in (
        (jxvector.Classifier(out_neurons=6, lin_neurons=9),
         txvector.Classifier(12, 6, lin_neurons=9, device="cpu")),
        (jxvector.Discriminator(lin_blocks=2, lin_neurons=9),
         txvector.Discriminator(12, lin_blocks=2, lin_neurons=9,
                                device="cpu")),
    ):
        variables = _pair(jm, tm, x)
        tm.train(train)
        jout = japply(jm, variables, jnp.asarray(x), train=train,
                      **({"mutable": ["batch_stats"]} if train else {}))
        _close(tm(_t(x)), jout[0] if train else jout)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_matches_jax(train):
    x = _x((3, 24, 12))
    jm = jresnet.ResNet(**RESNET)
    tm = tresnet.ResNet(12, device="cpu", **RESNET)
    variables = _pair(jm, tm, x)
    # SE on the first two stages only, 2-D BatchNorm over channels
    assert tm.block_0_0.se is not None and tm.block_2_0.se is None
    tm.train(train)
    out = tm(_t(x))
    jout = japply(jm, variables, jnp.asarray(x), train=train,
                  **({"mutable": ["batch_stats"]} if train else {}))
    _rel(out, jout[0] if train else jout)
    if train:
        _running_stats_equal(tm, jm, variables, jnp.asarray(x))


def test_resnet_flattens_channel_major():
    """``attn_in`` sees feature c * F' + f: a weight on one input column
    reads the channel and frequency the JAX order names."""
    tm = tresnet.ResNet(12, device="cpu", **RESNET).eval()
    freq = tm.attn_in.input_size // RESNET["channels"][-1]
    assert freq == 2  # 12 -> 12 -> 6 -> 3 -> 2 through the strides
    y = torch.zeros(1, 3, freq, RESNET["channels"][-1])
    y[0, :, 1, 5] = 1.0  # f = 1, c = 5
    flat = y.permute(0, 1, 3, 2).reshape(1, 3, -1)
    assert flat[0, 0].nonzero().item() == 5 * freq + 1


# -- scheduler, augmentation -------------------------------------------------

@pytest.mark.parametrize("mode", ["triangular", "triangular2", "exp_range"])
def test_cyclic_lr_matches_jax(mode, tmp_path):
    kw = dict(base_lr=1e-4, max_lr=1e-3, step_size=5, mode=mode, gamma=0.97)
    j, t = JaxCyclic(**kw), CyclicLRScheduler(**kw)
    for step in range(0, 33, 3):
        assert t(step) == pytest.approx(j(step), rel=1e-12)
    for _ in range(7):
        assert t() == pytest.approx(j(), rel=1e-12)
    t._save(tmp_path / "clr")
    fresh = CyclicLRScheduler(**kw)
    fresh._load(tmp_path / "clr")
    assert fresh.clr_iterations == 7 and fresh() == j()


@pytest.mark.parametrize("index", [0, 1, 2])
def test_speed_perturb_branch_matches_jax(index):
    wav = _x((2, 1600), seed=3)
    jsp = JaxSpeed(16000, speeds=[95, 100, 105])
    out = jsp.resamplers[index](jnp.asarray(wav))
    T = wav.shape[1]
    ref = (out[:, :T] if out.shape[1] >= T
           else jnp.pad(out, ((0, 0), (0, T - out.shape[1]))))
    _close(SpeedPerturb(16000, speeds=[95, 100, 105]).branch(_t(wav), index),
           ref)


def test_speed_perturb_draws_from_its_generator():
    sp = SpeedPerturb(16000, speeds=[95, 100, 105])
    wav = _t(_x((1, 800)))
    outs = [sp(wav, generator=torch.Generator().manual_seed(s))
            for s in range(6)]
    assert all(o.shape == wav.shape for o in outs)
    assert any(not torch.equal(outs[0], o) for o in outs[1:])


# -- PLDA and LDA ------------------------------------------------------------

def _speaker_stats(mod, seed=0, n_spk=6, per=8, dim=10):
    rng = np.random.default_rng(seed)
    means = 3 * rng.standard_normal((n_spk, dim))
    X = np.concatenate([m + rng.standard_normal((per, dim)) for m in means])
    y = np.repeat(np.arange(n_spk), per)
    return mod.StatObject(y, np.arange(len(y)), stat1=X)


def test_lda_matches_jax():
    j = jplda.LDA().do_lda(_speaker_stats(jplda), reduced_dim=4)
    t = tplda.LDA().do_lda(_speaker_stats(tplda), reduced_dim=4)
    np.testing.assert_array_equal(t.stat1, j.stat1)


def test_plda_training_and_scoring_match_jax():
    j = jplda.PLDA(rank_f=5).plda(_speaker_stats(jplda))
    t = tplda.PLDA(rank_f=5).plda(_speaker_stats(tplda))
    for name in ("mean", "F", "Sigma"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    enrol, test = _x((3, 10), seed=4), _x((4, 10), seed=5)
    np.testing.assert_array_equal(t.scoring(enrol, test),
                                  j.scoring(enrol, test))
    assert t.score_pair(enrol[0], test[0]) == j.score_pair(enrol[0], test[0])


def test_fast_plda_scoring_matches_jax():
    j = jplda.PLDA(rank_f=5).plda(_speaker_stats(jplda))
    enrol, test = _speaker_stats(jplda, seed=1), _speaker_stats(jplda, seed=2)
    ref = jplda.fast_PLDA_scoring(enrol, test, None, j.mean, j.F, j.Sigma)
    tenrol = tplda.StatObject(enrol.modelset, enrol.segset,
                              stat1=enrol.stat1)
    ttest = tplda.StatObject(test.modelset, test.segset, stat1=test.stat1)
    np.testing.assert_array_equal(
        tplda.fast_PLDA_scoring(tenrol, ttest, None, j.mean, j.F, j.Sigma),
        ref)


def test_plda_table_scoring_is_score_pair_per_trial():
    """The verification script reads trials off ``scoring`` over every
    utterance at once; each entry is the trial's ``score_pair``."""
    t = tplda.PLDA(rank_f=5).plda(_speaker_stats(tplda))
    embs = _x((6, 10), seed=6)
    table = t.scoring(embs, embs)
    for i in range(6):
        for j in range(6):
            assert table[i, j] == pytest.approx(
                t.score_pair(embs[i], embs[j]), rel=1e-9, abs=1e-9)


# -- LEAF --------------------------------------------------------------------

def _perturbed_init(jm, *args, seed=0, **kwargs):
    """The module's own initial variables, each multiplied by 1 + 0.05 N(0,
    1): values in range for parameters that a generic draw would break
    (centre frequencies, PCEN's exponents)."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(KEY, *args, **kwargs))
    return jax.tree_util.tree_map(
        lambda v: (v * (1 + 0.05 * rng.standard_normal(v.shape))).astype(
            np.float32), variables)


def test_gabor_conv1d_matches_jax():
    wav = _x((2, 400))
    jm = jcnn.GaborConv1d(out_channels=8, kernel_size=33)
    variables = _perturbed_init(jm, jnp.asarray(wav))
    tm = tcnn.GaborConv1d(8, 33, device="cpu")
    np.testing.assert_allclose(
        tm.kernel_params.detach().numpy(),
        np.asarray(jm.init(KEY, jnp.asarray(wav))["params"]["kernel_params"]),
        rtol=1e-6)
    load(tm, variables)
    _close(tm(_t(wav)), japply(jm, variables, jnp.asarray(wav)))


@pytest.mark.parametrize("per_channel", [False, True])
def test_exponential_moving_average_matches_the_scan(per_channel):
    x = np.abs(_x((2, 30, 5)))
    jm = jnorm.ExponentialMovingAverage(per_channel=per_channel)
    variables = _perturbed_init(jm, jnp.asarray(x))
    tm = tnorm.ExponentialMovingAverage(5, per_channel=per_channel,
                                        device="cpu")
    load(tm, variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))


def test_pcen_matches_jax():
    x = np.abs(_x((2, 30, 5)))
    jm = jnorm.PCEN()
    variables = _perturbed_init(jm, jnp.asarray(x))
    tm = tnorm.PCEN(5, device="cpu")
    load(tm, variables)
    _close(tm(_t(x)), japply(jm, variables, jnp.asarray(x)))


LEAF = dict(out_channels=4, window_len=2.0, window_stride=1.0)


def _leaf_pair():
    wav = _x((2, 800))
    jm = jfeatures.Leaf(**LEAF)
    variables = _perturbed_init(jm, jnp.asarray(wav))
    tm = tfeatures.Leaf(device="cpu", **LEAF)
    load(tm, variables)
    return wav, jm, tm, variables


def _jax_leaf_by_parts(wav, variables, pair):
    """JAX's Leaf step by step through its own modules, the squared
    modulus taken by ``pair``."""
    p = variables["params"]
    conv = jcnn.GaborConv1d(out_channels=8, kernel_size=33).apply(
        {"params": p["complex_conv"]}, jnp.asarray(wav)[..., None])
    out = pair(conv)
    out = jpool.GaussianLowpassPooling(kernel_size=33, stride=16).apply(
        {"params": p["pooling"]}, out)
    return jnorm.PCEN().apply({"params": p["compression"]},
                              jnp.maximum(out, 1e-5))


def test_leaf_matches_jax_with_each_filters_modulus():
    """The port's Leaf is JAX's chain with real_c**2 + imag_c**2 for
    filter c (ROADMAP C41)."""
    wav, _, tm, variables = _leaf_pair()
    ref = _jax_leaf_by_parts(
        wav, variables, lambda y: y[..., :4] ** 2 + y[..., 4:] ** 2)
    out = tm(_t(wav))
    assert out.shape == (2, 50, 4)
    _close(out, ref)


def test_jax_leaf_pairs_neighbouring_channels():
    """C41: JAX's Leaf squares and adds channels 2k and 2k+1 of the Gabor
    output, two real (or two imaginary) responses of neighbouring
    filters, so its output is not each filter's energy."""
    wav, jm, tm, variables = _leaf_pair()
    jout = np.asarray(japply(jm, variables, jnp.asarray(wav)))
    neighbours = _jax_leaf_by_parts(
        wav, variables,
        lambda y: jnp.sum(y.reshape(*y.shape[:2], 4, 2) ** 2, axis=-1))
    np.testing.assert_allclose(jout, np.asarray(neighbours), atol=ATOL)
    assert np.abs(jout - tm(_t(wav)).detach().numpy()).max() > 1e-2


# -- inference interfaces -----------------------------------------------------

def _interfaces():
    """JAX's and the port's ``EncoderClassifier`` over one ECAPA and
    classifier, the same weights and running statistics, each with its
    own package's unfused Fbank at 12 mels."""
    wav = 0.3 * _x((3, 4000), seed=6)
    jfbank = jfeatures.Fbank(n_mels=12)
    feats = jfbank(jnp.asarray(wav))
    jemb, jclf = jecapa.ECAPA_TDNN(**ECAPA), jecapa.Classifier(out_neurons=5)
    ev = draw_variables(jemb, feats, lengths=jnp.asarray(LENS), train=False)
    cv = draw_variables(jclf, jnp.ones((3, 1, ECAPA["lin_neurons"])),
                        train=False, seed=2)
    labels = ["ann", "bob", "cy", "dee", "eve"]
    jenc, tenc = JaxEncoder(), CategoricalEncoder()
    for enc in (jenc, tenc):
        enc.update_from_iterable(labels)
    temb = tecapa.ECAPA_TDNN(12, device="cpu", **ECAPA)
    tclf = tecapa.Classifier(ECAPA["lin_neurons"], 5, device="cpu")
    load(temb, ev)
    load(tclf, cv)
    jax_kw = dict(
        params={"embedding_model": ev["params"], "classifier": cv["params"]},
        model_state={"batch_stats": {"embedding_model": ev["batch_stats"]}})
    jmods = {"embedding_model": jemb, "classifier": jclf}
    tmods = {"embedding_model": temb, "classifier": tclf}
    jh = {"compute_features": jfbank, "label_encoder": jenc}
    th = {"compute_features": tfeatures.Fbank(n_mels=12, device="cpu"),
          "label_encoder": tenc}
    return wav, (jmods, jh, jax_kw), (tmods, th)


def test_encoder_classifier_matches_jax():
    wav, (jmods, jh, jkw), (tmods, th) = _interfaces()
    j = JaxEncoderClassifier(modules=jmods, hparams=jh, **jkw)
    t = EncoderClassifier(modules=tmods, hparams=th,
                          run_opts={"device": "cpu"})
    _rel(t.encode_batch(_t(wav), _t(LENS)),
         j.encode_batch(jnp.asarray(wav), jnp.asarray(LENS)))
    _rel(t.encode_batch(_t(wav), normalize=True),
         j.encode_batch(jnp.asarray(wav), normalize=True))
    jp, js, ji, jl = j.classify_batch(jnp.asarray(wav), jnp.asarray(LENS))
    tp, ts, ti, tl = t.classify_batch(_t(wav), _t(LENS))
    _rel(tp, jp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tl == list(jl)


def test_speaker_recognition_matches_jax():
    wav, (jmods, jh, jkw), (tmods, th) = _interfaces()
    j = JaxSpeakerRecognition(modules=jmods, hparams=jh, **jkw)
    t = SpeakerRecognition(modules={"embedding_model":
                                    tmods["embedding_model"]},
                           hparams=th, run_opts={"device": "cpu"})
    other = wav[::-1].copy()
    lens2 = LENS[::-1].copy()
    js, jd = j.verify_batch(jnp.asarray(wav), jnp.asarray(other),
                            jnp.asarray(LENS), jnp.asarray(lens2))
    ts, td = t.verify_batch(_t(wav), _t(other), _t(LENS), _t(lens2))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the same utterance scores 1 and passes
    same, ok = t.verify_batch(_t(wav), _t(wav))
    np.testing.assert_allclose(same.numpy(), 1.0, atol=1e-6)
    assert ok.all()


def test_mel_spectrogram_encoder_runs_the_embedding_model():
    _, _, (tmods, th) = _interfaces()
    enc = MelSpectrogramEncoder(
        modules={"embedding_model": tmods["embedding_model"]}, hparams=th,
        run_opts={"device": "cpu"})
    mel = _t(_x((20, 12)))
    one = enc.encode_mel_spectrogram(mel)
    both = enc.encode_mel_spectrogram_batch(torch.stack([mel, mel]))
    assert one.shape == (1, 1, ECAPA["lin_neurons"])
    torch.testing.assert_close(both[0], one[0])
