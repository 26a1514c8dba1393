"""The frame-level losses, clustering and scoring against the JAX package
on the same numpy inputs, on the CPU:

* ``bce_loss`` in every argument form and reduction (1e-6 absolute);
* ``kmeans_fit`` (centroids within 1e-5, the same assignments) and
  ``kmeans_predict``: on well-separated clusters, since float32 distances
  computed in another order may break a near tie the other way;
* each function of ``alignment/diarization.py`` (float64, 1e-10), and
  ``do_spec_clustering``'s labels equal up to a permutation;
* RTTM text, DER and EDER (exactly equal);
* ``SpeakerDiarization.diarize_segments`` over one ECAPA-TDNN whose JAX
  variables are drawn with numpy and carried into the port (embeddings
  within 1e-4 relative in L2, labels equal up to a permutation);
* ``Speech_Emotion_Diarization.diarize_file``: JAX skips the last window
  (ROADMAP C52), the port does not.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import warnings

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from speechbrain_tpu.alignment import diarization as jdiar
from speechbrain_tpu.inference.diarization import (
    SpeakerDiarization as JaxSpeakerDiarization,
)
from speechbrain_tpu.inference.diarization import (
    Speech_Emotion_Diarization as JaxEmotionDiarization,
)
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models import ECAPA_TDNN as jecapa
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.utils import kmeans as jkmeans
from speechbrain_tpu.utils.DER import DER as jax_DER
from speechbrain_tpu.utils.EDER import EDER as jax_EDER
from speechbrain_tpu_torch.alignment import diarization as tdiar
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.inference.diarization import (
    SpeakerDiarization,
    Speech_Emotion_Diarization,
)
from speechbrain_tpu_torch.inference.VAD import VAD
from speechbrain_tpu_torch.lobes import features as tfeatures
from speechbrain_tpu_torch.lobes.models import ECAPA_TDNN as tecapa
from speechbrain_tpu_torch.nnet import losses as tlosses
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.utils import kmeans as tkmeans
from speechbrain_tpu_torch.utils.DER import DER
from speechbrain_tpu_torch.utils.EDER import EDER
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_rnn import _t, _x, draw_variables

LOSS_ATOL = 1e-6
CENTROID_ATOL = 1e-5
SPECTRAL_ATOL = 1e-10
EMB_RTOL = 1e-4
SR = 16000
ECAPA = dict(channels=(16, 16, 16, 16, 48), attention_channels=8,
             res2net_scale=4, se_channels=8, lin_neurons=12)


def _same_partition(a, b):
    a, b = list(a), list(b)
    return (len(a) == len(b)
            and len(set(zip(a, b))) == len(set(a)) == len(set(b)))


# -- bce_loss ----------------------------------------------------------------

BCE_FORMS = {
    "plain": {},
    "weight": {"weight": "w"},
    "pos_weight": {"pos_weight": "pw"},
    "label_smoothing": {"label_smoothing": 0.1},
    "length": {"length": "len"},
    "all": {"weight": "w", "pos_weight": "pw", "label_smoothing": 0.2,
            "length": "len"},
}


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum",
                                       None])
@pytest.mark.parametrize("form", list(BCE_FORMS))
def test_bce_loss_matches_jax(form, reduction):
    logits = 3 * _x((3, 7))
    targets = (np.random.default_rng(1).random((3, 7)) > 0.5).astype(
        np.float32)
    arrays = {"w": np.abs(_x((3, 7), seed=2)), "pw": np.float32(2.5),
              "len": np.array([1.0, 0.6, 0.3], np.float32)}
    kw = {k: arrays.get(v, v) if isinstance(v, str) else v
          for k, v in BCE_FORMS[form].items()}
    jl = jlosses.bce_loss(
        jnp.asarray(logits), jnp.asarray(targets), reduction=reduction,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    tl = tlosses.bce_loss(
        _t(logits), _t(targets), reduction=reduction,
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_ATOL)


def test_bce_loss_on_large_logits_stays_finite():
    """log-sigmoid of the logits, not the log of a probability: a logit
    of 200 on a negative target costs 200, not infinity."""
    loss = tlosses.bce_loss(torch.tensor([[200.0, -200.0]]),
                            torch.tensor([[0.0, 1.0]]), reduction="sum")
    assert float(loss) == pytest.approx(400.0)


# -- k-means -----------------------------------------------------------------

def _blobs(seed=0, n=(12, 9, 15), dim=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((len(n), dim)) * 6
    return np.concatenate([c + rng.standard_normal((k, dim)) * 0.3
                           for c, k in zip(centers, n)]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_fit_matches_jax(seed):
    x = _blobs(seed)
    jc, ja = jkmeans.kmeans_fit(x, 3, rng=np.random.default_rng(seed))
    tc, ta = tkmeans.kmeans_fit(x, 3, rng=np.random.default_rng(seed),
                                device="cpu")
    np.testing.assert_allclose(tc, jc, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(
        tkmeans.kmeans_predict(_t(x), tc).numpy(),
        np.asarray(jkmeans.kmeans_predict(jnp.asarray(x), jnp.asarray(jc))))


def test_kmeans_keeps_an_empty_clusters_centroid_and_takes_a_generator():
    """Two identical first draws make one cluster empty: its centroid
    stays where it was, as in JAX; a ``torch.Generator`` draws the first
    centroids reproducibly on the tensor's device."""
    x = np.array([[0.0], [0.0], [10.0]], np.float32)

    class FirstTwo:
        def choice(self, n, size, replace):
            return np.array([0, 1])

    tc, ta = tkmeans.kmeans_fit(x, 2, rng=FirstTwo(), device="cpu")
    jc, jassign = jkmeans.kmeans_fit(x, 2, rng=FirstTwo())
    np.testing.assert_allclose(tc, jc)
    np.testing.assert_array_equal(ta, jassign)
    a = tkmeans.kmeans_fit(_t(_blobs()), 3,
                           rng=torch.Generator().manual_seed(4))
    b = tkmeans.kmeans_fit(_t(_blobs()), 3,
                           rng=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a[1], b[1])
    assert len(set(a[1].tolist())) == 3


ENTRY_POINTS = {
    "kmeans_fit": lambda: tkmeans.kmeans_fit(np.zeros((4, 2), np.float32),
                                             2),
    "do_spec_clustering": lambda: tdiar.do_spec_clustering(_embeddings(),
                                                           n_speakers=2),
    "SpeakerDiarization": lambda: SpeakerDiarization(
        modules={"embedding_model": Linear(2, 3, device="cpu")}),
    "Speech_Emotion_Diarization": lambda: Speech_Emotion_Diarization(
        modules={"model": Linear(2, 3, device="cpu")}),
    "VAD": lambda: VAD(modules={"model": Linear(1, 3, device="cpu")},
                       hparams={"sample_rate": SR}),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """k-means of an array, the spectral clustering and every interface
    run on ``"cuda"`` unless the caller asks for the CPU: here, where
    there is no card, they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((AssertionError, RuntimeError)):
        ENTRY_POINTS[name]()


# -- spectral clustering -----------------------------------------------------

def _embeddings(seed=0):
    rng = np.random.default_rng(seed)
    groups = [rng.standard_normal(8) for _ in range(3)]
    return np.concatenate([g + 0.2 * rng.standard_normal((k, 8))
                           for g, k in zip(groups, (7, 5, 6))])


SPECTRAL = {
    "get_affinity": lambda m, e: m.get_affinity(e),
    "p_pruning": lambda m, e: m.p_pruning(m.get_affinity(e), 0.4),
    "spectral_embedding": lambda m, e: m.spectral_embedding(
        m.p_pruning(m.get_affinity(e), 0.3), 3),
    "estimate_num_speakers": lambda m, e: m.estimate_num_speakers(
        m.p_pruning(m.get_affinity(e), 0.3), 6),
}


@pytest.mark.parametrize("name", list(SPECTRAL))
def test_spectral_functions_match_jax(name):
    e = _embeddings()
    t, j = SPECTRAL[name](tdiar, e), SPECTRAL[name](jdiar, e)
    np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                               atol=SPECTRAL_ATOL)


@pytest.mark.parametrize("n_speakers", [None, 3])
def test_do_spec_clustering_matches_jax(n_speakers):
    e = _embeddings(1)
    t = tdiar.do_spec_clustering(e, n_speakers=n_speakers, device="cpu")
    j = jdiar.do_spec_clustering(e, n_speakers=n_speakers)
    assert _same_partition(t, j) and len(t) == len(e)


def test_estimate_num_speakers_never_answers_one():
    """The JAX package's policy, mirrored: 2 plus the largest gap's index
    after the first, so one tight group still reads as 2 speakers."""
    e = np.ones((6, 4)) + 1e-3 * np.random.default_rng(0).standard_normal(
        (6, 4))
    A = tdiar.p_pruning(tdiar.get_affinity(e))
    assert tdiar.estimate_num_speakers(A) == jdiar.estimate_num_speakers(
        A) >= 2


def test_merge_rttm_der_and_eder_match_jax(tmp_path):
    segs = [(0.0, 1.5, 0), (0.75, 2.25, 0), (2.25, 3.0, 1), (3.5, 4.0, 1),
            (4.0, 5.25, 1), (5.25, 6.0, 0)]
    t, j = tdiar.merge_ssegs_same_speaker(segs), \
        jdiar.merge_ssegs_same_speaker(segs)
    assert t == j and len(t) == 4 and tdiar.merge_ssegs_same_speaker([]) \
        == []
    tdiar.write_rttm(t, "rec", tmp_path / "t.rttm")
    jdiar.write_rttm(j, "rec", tmp_path / "j.rttm")
    assert (tmp_path / "t.rttm").read_bytes() == \
        (tmp_path / "j.rttm").read_bytes()
    ref = [(0.0, 2.1, "A"), (2.1, 3.2, "B"), (3.4, 6.0, "A")]
    hyp = [(s, e, str(lab)) for s, e, lab in t]
    for collar in (0.0, 0.25):
        assert DER(ref, hyp, collar=collar) == jax_DER(ref, hyp,
                                                       collar=collar)
    assert DER(ref, ref, collar=0.0) == 0.0
    pred = [{"start": 0.0, "end": 1.0, "emotion": "h"},
            {"start": 1.3, "end": 2.0, "emotion": "s"}]
    emo = [{"start": 0.2, "end": 1.1, "emo": "h"},
           {"start": 1.5, "end": 2.4, "emo": "a"}]
    assert EDER(pred, "x", 2.5, emo) == jax_EDER(pred, "x", 2.5, emo) > 0


def test_reexports_and_the_deprecated_alias():
    from speechbrain_tpu_torch.integrations.alignment import (
        diarization as integ,
    )

    assert integ.do_spec_clustering is tdiar.do_spec_clustering
    assert integ.write_rttm is tdiar.write_rttm
    import importlib
    import sys

    sys.modules.pop("speechbrain_tpu_torch.processing.diarization", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        alias = importlib.import_module(
            "speechbrain_tpu_torch.processing.diarization")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert alias.p_pruning is tdiar.p_pruning


# -- the interfaces ----------------------------------------------------------

def _meeting(seconds=3.0, seed=0):
    """Alternating 0.5 s tones of two pitches over a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    sig = 0.01 * rng.standard_normal(len(t))
    for k in range(int(seconds / 0.5)):
        seg = (t >= 0.5 * k) & (t < 0.5 * (k + 1))
        sig[seg] += 0.5 * np.sin(2 * np.pi * (220 if k % 2 else 660)
                                 * t[seg])
    return sig.astype(np.float32)


class Jitted:
    """A flax module whose ``apply`` in evaluation runs as one compiled
    program: the JAX interfaces and scripts call ``module.apply(variables,
    x[, train=False])`` once a segment, which op by op takes about a second
    for an ECAPA-TDNN."""

    def __init__(self, module):
        self._apply = jax.jit(lambda v, x: module.apply(v, x, train=False))

    def apply(self, variables, x, train=False):
        return self._apply(variables, x)


def test_speaker_diarization_matches_jax(monkeypatch):
    """Six 0.5 s segments of two alternating tones: the same embeddings
    (1e-4 relative), labels and merged segments up to a permutation."""
    sig = _meeting()
    segments = [(0.5 * k, 0.5 * (k + 1)) for k in range(6)]
    jfbank = jfeatures.Fbank(n_mels=16)
    jm = jecapa.ECAPA_TDNN(**ECAPA)
    variables = draw_variables(jm, jfbank(jnp.asarray(sig[None, :8000])),
                               train=False)
    tm = tecapa.ECAPA_TDNN(16, device="cpu", **ECAPA)
    load(tm, variables)
    j = JaxSpeakerDiarization(
        modules={"embedding_model": Jitted(jm)},
        params={"embedding_model": variables["params"]},
        model_state={"batch_stats": {
            "embedding_model": variables["batch_stats"]}},
        hparams={"compute_features": jfbank, "sample_rate": SR})
    t = SpeakerDiarization(
        modules={"embedding_model": tm},
        hparams={"compute_features": tfeatures.Fbank(n_mels=16,
                                                     device="cpu"),
                 "sample_rate": SR},
        run_opts={"device": "cpu"})
    jembs = []
    clustering = jdiar.do_spec_clustering
    monkeypatch.setattr(jdiar, "do_spec_clustering",
                        lambda e, **kw: jembs.append(e) or clustering(e,
                                                                      **kw))
    jout = j.diarize_segments(sig, segments, n_speakers=2)
    temb = t.embed_segments(_t(sig), segments)
    assert np.linalg.norm(temb - jembs[0]) <= EMB_RTOL * np.linalg.norm(
        jembs[0])
    tout = t.diarize_segments(_t(sig), segments, n_speakers=2)
    assert [s[:2] for s in tout] == [s[:2] for s in jout]
    assert _same_partition([s[2] for s in tout], [s[2] for s in jout])
    assert len(tout) == 6


class _FrameLinear(nn.Module):
    """A ``Linear`` that takes the interfaces' ``train`` argument."""

    @nn.compact
    def __call__(self, x, train=False):
        return JaxLinear(n_neurons=4, name="lin")(x)


def test_c52_jax_skips_the_last_window(tmp_path):
    """2 s of audio, a 1 s window every 0.5 s: JAX labels the windows at 0
    and 0.5 s and never the one at 1.0 s, which the port labels; the
    windows both label agree (a fixed ``Linear`` over the Fbank, 4
    classes, the last frame's argmax)."""
    sig = _meeting(2.0, seed=3)
    path = str(tmp_path / "emo.wav")
    write_audio(path, sig, SR)
    w = 0.1 * _x((20, 4), seed=5)
    b = np.array([0.0, 1.0, -1.0, 0.5], np.float32)
    j = JaxEmotionDiarization(
        modules={"model": _FrameLinear()},
        params={"model": {"lin": {"kernel": w, "bias": b}}},
        hparams={"compute_features": jfeatures.Fbank(n_mels=20),
                 "sample_rate": SR})
    lin = Linear(4, 20, device="cpu")
    load(lin, {"kernel": w, "bias": b})
    t = Speech_Emotion_Diarization(
        modules={"model": lin},
        hparams={"compute_features": tfeatures.Fbank(n_mels=20,
                                                     device="cpu"),
                 "sample_rate": SR},
        run_opts={"device": "cpu"})
    jseg = j.diarize_file(path)
    tseg = t.diarize_file(path)
    assert [s["start"] for s in jseg] == [0.0, 0.5]
    assert [s["start"] for s in tseg] == [0.0, 0.5, 1.0]
    assert tseg[-1]["end"] == 2.0 and jseg[-1]["end"] == 1.5
    assert tseg[:2] == jseg
