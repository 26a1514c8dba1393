"""``inference/VAD.py`` against the JAX package's ``VAD`` on the same numpy
inputs and the same weights, on the CPU:

* every static method (``apply_threshold``, ``create_chunks``,
  ``merge_close_segments``, ``remove_short_segments``) and every method
  of the boundary pipeline over a file (``get_boundaries``,
  ``upsample_VAD``, ``upsample_boundaries``, ``get_segments``,
  ``save_boundaries``, ``energy_VAD``, ``double_check_speech_segments``):
  equal, the signals within 1e-6;
* ``get_speech_prob_chunk`` through a CRDNN (width 16) and ``Linear``
  whose JAX variables are drawn with numpy and carried into the port
  (1e-5 absolute);
* ``get_speech_segments`` in the overlapped mode: equal boundaries, and
  posteriors within 1e-5;
* the default mode's chunks (ROADMAP C51): JAX keeps the extra frame a
  centred Fbank gives each 10 s chunk, so its posteriors lie k frames late
  in chunk k; the port's do not.

The fixed model of the file tests is a ``Linear`` over the port's Fbank,
given to both sides, so that a frame's posterior is a known function of
that frame alone.
"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from speechbrain_tpu.inference.VAD import VAD as JaxVAD
from speechbrain_tpu.lobes import features as jfeatures
from speechbrain_tpu.lobes.models.CRDNN import CRDNN as JaxCRDNN
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.inference.VAD import VAD
from speechbrain_tpu_torch.lobes import features as tfeatures
from speechbrain_tpu_torch.lobes.models.CRDNN import CRDNN
from speechbrain_tpu_torch.nnet.containers import Sequential
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_diarization import Jitted
from test_torch_rnn import _t, _x, draw_variables

PROB_ATOL = 1e-5
SIGNAL_ATOL = 1e-6
SR = 16000
N_MELS = 40
# tone bursts (seconds) over a noise floor
BURSTS = ((0.5, 1.4), (2.0, 2.3), (2.45, 3.6))


def _bursts(seconds=4.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    sig = 0.01 * rng.standard_normal(len(t))
    for k, (s, e) in enumerate(BURSTS):
        seg = (t >= s) & (t < e)
        sig[seg] += 0.5 * np.sin(2 * np.pi * (200 + 150 * k) * t[seg])
    return sig.astype(np.float32)


def _linear_pair(sig, n_mels=N_MELS):
    """JAX's and the port's VAD over one ``Linear`` on the port's Fbank
    (both sides get the same features, so that the comparison is of the
    VAD's own arithmetic: the two packages' Fbanks differ by up to about
    1e-3 dB on the noise floor): the logit is 0.2 times the frame's mean
    dB, less the midpoint of the signal's loudest and quietest frames."""
    fbank = tfeatures.Fbank(n_mels=n_mels, device="cpu")
    level = fbank(_t(sig[None])).numpy().mean(axis=-1)
    w = np.full((n_mels, 1), 0.2 / n_mels, np.float32)
    b = np.array([-0.1 * (level.max() + level.min())], np.float32)
    j = JaxVAD(modules={"model": JaxLinear(n_neurons=1)},
               params={"model": {"kernel": w, "bias": b}},
               hparams={"compute_features": lambda wavs: jnp.asarray(
                   fbank(_t(np.asarray(wavs))).numpy()),
                   "sample_rate": SR})
    lin = Linear(1, n_mels, device="cpu")
    load(lin, {"kernel": w, "bias": b})
    t = VAD(modules={"model": lin},
            hparams={"compute_features": fbank, "sample_rate": SR},
            run_opts={"device": "cpu"})
    return j, t


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    sig = _bursts()
    path = str(tmp_path_factory.mktemp("vad") / "bursts.wav")
    write_audio(path, sig, SR)
    j, t = _linear_pair(sig)
    return j, t, path, sig


# -- the static methods ------------------------------------------------------

@pytest.mark.parametrize("th", [(0.5, 0.25), (0.6, 0.6), (0.3, 0.7)])
def test_apply_threshold_matches_jax(th):
    prob = np.random.default_rng(2).random((2, 300, 1)).astype(np.float32)
    prob = np.cumsum(prob - 0.5, axis=1) / 10 + 0.5
    t = VAD.apply_threshold(_t(prob), *th)
    np.testing.assert_array_equal(t, JaxVAD.apply_threshold(prob, *th))
    assert 0 < t.sum() < t.size


@pytest.mark.parametrize("T,size,stride", [(16000, 4000, 2000),
                                           (16005, 4000, 4000),
                                           (3000, 4000, 2000)])
def test_create_chunks_matches_jax(T, size, stride):
    x = _x((1, T))
    np.testing.assert_array_equal(
        VAD.create_chunks(_t(x), size, stride).numpy(),
        np.asarray(JaxVAD.create_chunks(jnp.asarray(x), size, stride)))


def test_merge_and_remove_match_jax():
    b = np.array([[0.0, 0.4], [0.5, 0.9], [0.95, 1.2], [2.0, 2.1],
                  [3.0, 3.5]])
    for close in (0.05, 0.1, 0.6):
        m = VAD.merge_close_segments(b, close)
        np.testing.assert_array_equal(m, JaxVAD.merge_close_segments(b,
                                                                     close))
        for length in (0.2, 0.3):
            np.testing.assert_array_equal(
                VAD.remove_short_segments(m, length),
                JaxVAD.remove_short_segments(m, length))
    empty = np.zeros((0, 2))
    assert len(VAD.merge_close_segments(empty)) == 0
    assert len(VAD.remove_short_segments(empty)) == 0


# -- the pipeline over a file ------------------------------------------------

def test_boundary_methods_match_jax(pair, tmp_path):
    j, t, path, sig = pair
    # one chunk: the file in the default mode, where C51 does not enter
    jprob = j.get_speech_prob_file(path, small_chunk_size=4)
    tprob = t.get_speech_prob_file(path, small_chunk_size=4)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob),
                               atol=PROB_ATOL)
    th = t.apply_threshold(tprob)
    np.testing.assert_array_equal(th, j.apply_threshold(jprob))
    for unit in ("seconds", "frames"):
        np.testing.assert_array_equal(t.get_boundaries(th, unit),
                                      j.get_boundaries(th, unit))
    bounds = t.get_boundaries(th)
    assert len(bounds) == len(BURSTS)
    np.testing.assert_allclose(
        t.upsample_VAD(_t(th), path).numpy(),
        np.asarray(j.upsample_VAD(th, path)), atol=SIGNAL_ATOL)
    np.testing.assert_allclose(
        t.upsample_boundaries(bounds, path).numpy(),
        np.asarray(j.upsample_boundaries(bounds, path)), atol=SIGNAL_ATOL)
    for margins in ((0.1, 0.1), (0.6, 0.0)):
        ts, js = (t.get_segments(bounds, path, *margins),
                  j.get_segments(bounds, path, *margins))
        assert len(ts) == len(js) == len(BURSTS)
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for audio_file in (None, path):
        lines = t.save_boundaries(bounds, tmp_path / "t.txt", False,
                                  audio_file)
        assert lines == j.save_boundaries(bounds, tmp_path / "j.txt", False,
                                          audio_file)
        assert (tmp_path / "t.txt").read_text() == \
            (tmp_path / "j.txt").read_text()
    np.testing.assert_array_equal(t.energy_VAD(path, bounds, 0.4),
                                  j.energy_VAD(path, bounds, 0.4))
    for speech_th in (0.5, 0.9):
        np.testing.assert_array_equal(
            t.double_check_speech_segments(bounds, path, speech_th),
            j.double_check_speech_segments(bounds, path, speech_th))


def test_overlapped_get_speech_segments_matches_jax(pair):
    """JAX's ``get_speech_segments`` has no overlapped mode; its stages
    are run in that mode one by one. The posteriors agree within 1e-5 and
    the boundaries are equal, with and without the energy refinement."""
    j, t, path, _ = pair
    kw = dict(small_chunk_size=1, overlap_small_chunk=True)
    jprob = j.get_speech_prob_file(path, **kw)
    np.testing.assert_allclose(t.get_speech_prob_file(path, **kw).numpy(),
                               np.asarray(jprob), atol=PROB_ATOL)
    for energy in (False, True):
        jb = j.get_boundaries(j.apply_threshold(jprob))
        if energy:
            jb = j.energy_VAD(path, jb, 0.5, 0.0)
        jb = j.remove_short_segments(j.merge_close_segments(jb))
        jb = j.double_check_speech_segments(jb, path)
        tb = t.get_speech_segments(path, apply_energy_VAD=energy, **kw)
        np.testing.assert_array_equal(tb, jb)
        assert len(tb) >= 1


def test_get_speech_prob_chunk_matches_jax_through_bridged_weights():
    """A CRDNN (2 CNN blocks of 4 and 8 channels, a 2-layer LSTM of 16,
    one DNN block of 16) and a ``Linear`` in sequence, evaluation mode,
    on 16 mels: the sigmoid posteriors within 1e-5."""
    wavs = 0.3 * _x((2, 8000), seed=4)
    jfbank = jfeatures.Fbank(n_mels=16)
    feats = jfbank(jnp.asarray(wavs))
    crdnn = dict(cnn_blocks=2, cnn_channels=(4, 8),
                 inter_layer_pooling_size=(2, 2), rnn_layers=2,
                 rnn_neurons=16, rnn_bidirectional=False, dnn_blocks=1,
                 dnn_neurons=16)
    jm = nn.Sequential([JaxCRDNN(**crdnn), JaxLinear(n_neurons=1)])
    v = draw_variables(jm, feats)
    tm = Sequential([CRDNN(input_size=16, device="cpu", **crdnn),
                     Linear(1, 16, device="cpu")])
    load(tm.layers[0], {"params": v["params"]["layers_0"],
                        "batch_stats": v["batch_stats"]["layers_0"]})
    load(tm.layers[1], v["params"]["layers_1"])
    j = JaxVAD(modules={"model": Jitted(jm)},
               params={"model": v["params"]},
               model_state={"batch_stats": {"model": v["batch_stats"]}},
               hparams={"compute_features": jfbank, "sample_rate": SR})
    t = VAD(modules={"model": tm},
            hparams={"compute_features": tfeatures.Fbank(n_mels=16,
                                                         device="cpu"),
                     "sample_rate": SR},
            run_opts={"device": "cpu"})
    tp = t.get_speech_prob_chunk(_t(wavs))
    assert tp.shape == (2, 51, 1)
    np.testing.assert_allclose(
        tp.numpy(), np.asarray(j.get_speech_prob_chunk(jnp.asarray(wavs))),
        atol=PROB_ATOL)


def test_a_multiclass_models_last_class_is_speech(pair):
    """A model of 3 classes: the posterior of speech is the softmax of
    its last, as in JAX."""
    _, _, _, sig = pair
    w = 0.05 * _x((N_MELS, 3), seed=8)
    b = np.zeros(3, np.float32)
    fbank = tfeatures.Fbank(n_mels=N_MELS, device="cpu")
    j = JaxVAD(modules={"model": JaxLinear(n_neurons=3)},
               params={"model": {"kernel": w, "bias": b}},
               hparams={"compute_features": lambda wavs: jnp.asarray(
                   fbank(_t(np.asarray(wavs))).numpy()),
                   "sample_rate": SR})
    lin = Linear(3, N_MELS, device="cpu")
    load(lin, {"kernel": w, "bias": b})
    t = VAD(modules={"model": lin},
            hparams={"compute_features": fbank, "sample_rate": SR},
            run_opts={"device": "cpu"})
    np.testing.assert_allclose(
        t.get_speech_prob_chunk(_t(sig[None])).numpy(),
        np.asarray(j.get_speech_prob_chunk(jnp.asarray(sig[None]))),
        atol=PROB_ATOL)


def test_c51_jax_vad_drifts_a_frame_a_chunk(tmp_path):
    """30 s in three 10 s chunks, each of which the centred Fbank turns
    into 1001 frames. JAX lays all 1001 end to end and cuts the file to
    3000 frames, so its chunk k starts k frames late and the file's last
    2 frames are lost; the port keeps 1000 a chunk, so chunk k starts at
    frame k * 1000 = k * 10 s."""
    rng = np.random.default_rng(7)
    # noise whose level moves every 10 ms, so neighbouring frames differ
    sig = _x((30 * SR,), seed=7) * np.repeat(
        rng.uniform(0.01, 1.0, 3000), 160).astype(np.float32)
    path = str(tmp_path / "long.wav")
    write_audio(path, sig, SR)
    j, t = _linear_pair(sig)
    jp = np.asarray(j.get_speech_prob_file(path))[0, :, 0]
    tp = t.get_speech_prob_file(path).numpy()[0, :, 0]
    chunks = t.get_speech_prob_chunk(t.load_audio(path).reshape(3, -1))
    chunks = chunks[..., 0].numpy()
    assert chunks.shape == (3, 1001) and len(jp) == len(tp) == 3000
    np.testing.assert_allclose(tp, chunks[:, :1000].reshape(-1),
                               atol=PROB_ATOL)
    np.testing.assert_allclose(jp, chunks.reshape(-1)[:3000],
                               atol=PROB_ATOL)
    for k in (1, 2):
        # at the same index JAX holds the frame k places earlier
        span = slice(k * 1000 + k, (k + 1) * 1000)
        np.testing.assert_allclose(jp[span], tp[k * 1000: (k + 1) * 1000
                                                - k], atol=PROB_ATOL)
        assert np.abs(tp[span] - jp[span]).max() > 0.1
