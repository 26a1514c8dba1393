"""The enhancement modules against the JAX package at a tiny width, the
same numpy inputs through both, the JAX weights (drawn with numpy into
the shapes of flax's variables) carried over by ``utils/jax_bridge``:

* ``InstanceNorm1d``, ``mse_loss``/``l1_loss`` under every reduction;
* ``ISTFT`` where the window fills the frame (2-D and 4-D multi-channel),
  and C48: JAX's round trip beside the port's where the window is shorter
  than the frame;
* every signal-processing function: amplitudes, normalisation,
  rescaling, ``convolve1d`` direct (each padding type, strides, groups)
  and by FFT (rotations, a kernel longer than the signal),
  ``reverberate`` at each rank, ``notch_filter``, ``resynthesize``,
  ``gabor_impulse_response``;
* ``stoi_loss`` (host numpy in float64) on arrays and on tensors;
* the four ``MaskingSE`` models (the BatchNorm ones in training mode
  with their running statistics too), ``CNNTransformerSE`` causal and
  not and with a custom embedding, ``EnhanceResnet``;
* ``SpectralMaskEnhancement`` (16 kHz, window = frame) and
  ``WaveformEnhancement`` end to end, ``enhance_file`` included;
* C47: a stage with no finite loss reports 0.0 in JAX and NaN in the
  port, and no ``min_key``/``min_keys`` ranking picks a NaN checkpoint.

Tolerance: 1e-5 relative L2 in float32 (module outputs, transforms,
losses), 1e-6 absolute for the running statistics, 1e-6 for STOI (the
same float64 arithmetic)."""

import torch_threads  # noqa: F401  (one torch thread a worker)
import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechbrain_tpu.inference.enhancement import (
    SpectralMaskEnhancement as JaxSpectralMask,
)
from speechbrain_tpu.inference.enhancement import (
    WaveformEnhancement as JaxWaveform,
)
from speechbrain_tpu.lobes.models import MaskingSE as jse
from speechbrain_tpu.lobes.models.EnhanceResnet import (
    EnhanceResnet as JaxEnhanceResnet,
)
from speechbrain_tpu.lobes.models.transformer.TransformerSE import (
    CNNTransformerSE as JaxCNNTransformerSE,
)
from speechbrain_tpu.nnet import losses as jlosses
from speechbrain_tpu.nnet.linear import Linear as JaxLinear
from speechbrain_tpu.nnet.loss import stoi_loss as jstoi
from speechbrain_tpu.nnet.normalization import (
    InstanceNorm1d as JaxInstanceNorm1d,
)
from speechbrain_tpu.processing import features as jfeatures
from speechbrain_tpu.processing import signal_processing as jsp
from speechbrain_tpu.dataio.dataset import DynamicItemDataset as JaxDataset
from speechbrain_tpu.utils.epoch_loop import EpochCounter as JaxEpochCounter
from speechbrain_tpu_torch.dataio.dataio import write_audio
from speechbrain_tpu_torch.dataio.dataset import DynamicItemDataset
from speechbrain_tpu_torch.inference.enhancement import (
    SpectralMaskEnhancement,
    WaveformEnhancement,
)
from speechbrain_tpu_torch.lobes.models import MaskingSE as tse
from speechbrain_tpu_torch.lobes.models.EnhanceResnet import EnhanceResnet
from speechbrain_tpu_torch.lobes.models.transformer.TransformerSE import (
    CNNTransformerSE,
)
from speechbrain_tpu_torch.nnet import losses as tlosses
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.loss import stoi_loss as tstoi
from speechbrain_tpu_torch.nnet.normalization import InstanceNorm1d
from speechbrain_tpu_torch.processing import features as tfeatures
from speechbrain_tpu_torch.processing import signal_processing as tsp
from speechbrain_tpu_torch.utils.checkpoints import Checkpointer
from speechbrain_tpu_torch.utils.epoch_loop import EpochCounter
from speechbrain_tpu_torch.utils.jax_bridge import load
from test_torch_host_loop import JaxTiny, Tiny, _data, _dataset, _linear
from test_torch_rnn import _jax, _t, _x, draw_variables, japply

RTOL = 1e-5
STATS_ATOL = 1e-6
STOI_ATOL = 1e-6


def _rel(a, b, rtol=RTOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.linalg.norm(a - b)
    assert err <= rtol * max(np.linalg.norm(b), 1e-30), (
        what, err, np.linalg.norm(b))


def _check(jm, tm, x, train=False, **kwargs):
    """The port's output against JAX's on ``x`` (numpy), weights and
    statistics drawn for ``jm``; in training mode also the running
    statistics after the step. Returns the variables."""
    variables = draw_variables(jm, jnp.asarray(x), **kwargs)
    load(tm, variables)
    if train:
        ref, new = japply(jm, variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"], **kwargs)
        out = tm.train()(_t(x))
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
        expected = load(copy.deepcopy(tm), {"params": variables["params"],
                                            "batch_stats": stats})
        n = 0
        for (name, a), (_, b) in zip(tm.named_buffers(),
                                     expected.named_buffers()):
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           atol=STATS_ATOL, err_msg=name)
                n += 1
        assert n > 0
    else:
        ref = japply(jm, variables, jnp.asarray(x), **kwargs)
        with torch.no_grad():
            out = tm.eval()(_t(x))
    _rel(out, ref, what=type(tm).__name__)
    return variables


# -- layers and losses -------------------------------------------------------

@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(affine):
    x = 2.0 + 3.0 * _x((2, 11, 6), seed=1)
    _check(JaxInstanceNorm1d(affine=affine),
           InstanceNorm1d(6, affine=affine, device="cpu"), x)


@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
@pytest.mark.parametrize("name", ["mse_loss", "l1_loss"])
def test_regression_losses_match_jax(name, reduction):
    p, t = _x((3, 10, 4), seed=2), _x((3, 10, 4), seed=3)
    lens = np.array([1.0, 0.55, 0.25], np.float32)
    ours = getattr(tlosses, name)(_t(p), _t(t), _t(lens), reduction=reduction)
    theirs = getattr(jlosses, name)(jnp.asarray(p), jnp.asarray(t),
                                    jnp.asarray(lens), reduction=reduction)
    _rel(ours, theirs)


# -- STFT / ISTFT ------------------------------------------------------------

def _spectrum(shape, seed):
    pair = _x(shape + (2,), seed=seed)
    return (pair[..., 0] + 1j * pair[..., 1]).astype(np.complex64)


@pytest.mark.parametrize("window_fn", ["hamming", "hann"])
def test_istft_matches_jax_where_the_window_fills_the_frame(window_fn):
    kw = dict(n_fft=512, win_length=32, hop_length=16, window_fn=window_fn)
    spec = _spectrum((2, 21, 257), seed=4)
    ours = tfeatures.ISTFT(16000, device="cpu", **kw)
    theirs = jfeatures.ISTFT(16000, **kw)
    _rel(ours(torch.from_numpy(spec), sig_length=2900),
         theirs(jnp.asarray(spec), sig_length=2900))
    multi = _spectrum((2, 21, 257, 3), seed=5)
    out = ours(torch.from_numpy(multi))
    assert out.shape == (2, 5376, 3)
    _rel(out, theirs(jnp.asarray(multi)))


def _round_trip_error(stft, x, to_array, jit=False):
    def round_trip(a):
        return stft.inverse()(stft(a), sig_length=x.shape[1])

    rec = (jax.jit(round_trip) if jit else round_trip)(to_array(x))
    rec = np.asarray(rec.numpy() if isinstance(rec, torch.Tensor) else rec)
    return np.linalg.norm(rec - x) / np.linalg.norm(x)


def test_c48_port_istft_inverts_a_short_window_jax_does_not():
    """8 kHz, ``n_fft`` 512, 32 ms windows (256 samples): JAX's ``ISTFT``
    windows the first 256 samples of each frame where its ``STFT`` put
    the window in the middle (relative error about 1: 1.05 on this half
    second, 0.90 on longer noise); the port's puts
    it where its ``STFT`` did (at most 1e-5). At 16 kHz, where the window
    fills the frame, both invert."""
    x = _x((1, 4000), seed=7)
    kw = dict(n_fft=512, win_length=32, hop_length=16)
    jax_err = _round_trip_error(jfeatures.STFT(8000, backend="rfft", **kw),
                                x, jnp.asarray, jit=True)
    port_err = _round_trip_error(tfeatures.STFT(8000, device="cpu", **kw),
                                 x, torch.from_numpy)
    assert jax_err > 0.5
    assert port_err <= 1e-5
    x16 = _x((1, 8000), seed=8)
    assert _round_trip_error(jfeatures.STFT(16000, backend="rfft", **kw),
                             x16, jnp.asarray, jit=True) <= 1e-5
    assert _round_trip_error(tfeatures.STFT(16000, device="cpu", **kw),
                             x16, torch.from_numpy) <= 1e-5


def test_stft_inverse_keeps_the_window():
    """The port's ``inverse`` carries the window function, normalisation
    and centring: a Hann, normalised STFT inverts."""
    stft = tfeatures.STFT(16000, window_fn="hann", normalized_stft=True,
                          device="cpu")
    x = _x((1, 4000), seed=9)
    assert _round_trip_error(stft, x, torch.from_numpy) <= 1e-5


# -- signal processing -------------------------------------------------------

@pytest.mark.parametrize("amp_type", ["avg", "peak"])
@pytest.mark.parametrize("scale", ["linear", "dB"])
def test_amplitude_normalize_rescale_match_jax(amp_type, scale):
    x = _x((3, 50), seed=10)
    lens = np.array([[50.0], [30.0], [12.0]], np.float32)
    for length in (None, lens):
        jl = None if length is None else jnp.asarray(length)
        tl = None if length is None else _t(length)
        _rel(tsp.compute_amplitude(_t(x), tl, amp_type, scale),
             jsp.compute_amplitude(jnp.asarray(x), jl, amp_type, scale))
        _rel(tsp.normalize(_t(x), tl, amp_type),
             jsp.normalize(jnp.asarray(x), jl, amp_type))
        _rel(tsp.rescale(_t(x), tl, -12.0 if scale == "dB" else 0.3,
                         amp_type, scale),
             jsp.rescale(jnp.asarray(x), jl, -12.0 if scale == "dB" else 0.3,
                         amp_type, scale))
    _rel(tsp.compute_amplitude(_t(x[0]), 50, amp_type, scale),
         jsp.compute_amplitude(jnp.asarray(x[0]), 50, amp_type, scale))
    assert tsp.dB_to_amplitude(-6.0) == jsp.dB_to_amplitude(-6.0)


@pytest.mark.parametrize("pad_type", ["constant", "reflect", "replicate"])
def test_convolve1d_direct_matches_jax(pad_type):
    x = _x((2, 40, 4), seed=11)
    k = _x((6, 5, 2), seed=12)
    for kwargs in (dict(padding=(2, 2), pad_type=pad_type, groups=2),
                   dict(padding=(4, 0), pad_type=pad_type, stride=3,
                        groups=2),
                   dict(padding=1, groups=2)):
        _rel(tsp.convolve1d(_t(x), _t(k), **kwargs),
             jsp.convolve1d(jnp.asarray(x), jnp.asarray(k), **kwargs),
             what=str(kwargs))


@pytest.mark.parametrize("K,rotation", [(9, 0), (9, 4), (70, 13)],
                         ids=["no_rotation", "rotated", "kernel_too_long"])
def test_convolve1d_fft_matches_jax(K, rotation):
    x = _x((2, 48, 3), seed=13)
    k = _x((1, K, 3), seed=14)
    ours = tsp.convolve1d(_t(x), _t(k), use_fft=True,
                          rotation_index=torch.tensor(rotation))
    _rel(ours, jsp.convolve1d(jnp.asarray(x), jnp.asarray(k), use_fft=True,
                              rotation_index=rotation))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_reverberate_matches_jax(rank):
    x = _x((2, 300, 1), seed=15)[(0, slice(None), 0) if rank == 1 else
                                 (Ellipsis, 0) if rank == 2 else ()]
    rir = _x((1, 40), seed=16) * np.exp(-np.arange(40) / 8.0)[None]
    rir[0, 5] = 3.0  # the direct path: rotation 5
    for amp in ("avg", "peak"):
        _rel(tsp.reverberate(_t(x), _t(rir.astype(np.float32)), amp),
             jsp.reverberate(jnp.asarray(x), jnp.asarray(rir, jnp.float32),
                             amp))


def test_notch_filter_and_gabor_match_jax():
    for freq, width in ((0.25, 101), (0.6, 31)):
        _rel(tsp.notch_filter(freq, width, device="cpu"),
             jsp.notch_filter(freq, width))
    t = np.arange(-20, 21, dtype=np.float32)
    center = np.linspace(0.1, 2.5, 5).astype(np.float32)
    fwhm = np.linspace(2.0, 9.0, 5).astype(np.float32)
    ours = tsp.gabor_impulse_response(_t(t), _t(center), _t(fwhm))
    theirs = jsp.gabor_impulse_response(jnp.asarray(t), jnp.asarray(center),
                                        jnp.asarray(fwhm))
    assert ours.dtype == torch.complex64
    _rel(torch.view_as_real(ours), np.stack(
        [np.real(theirs), np.imag(theirs)], -1))


def test_resynthesize_matches_jax():
    kw = dict(n_fft=512, win_length=32, hop_length=16)
    noisy = 2.5 * _x((2, 3000), seed=17)
    mag = np.abs(_x((2, 12, 257), seed=18)) * 4.0
    ts = tfeatures.STFT(16000, device="cpu", **kw)
    js = jfeatures.STFT(16000, backend="rfft", **kw)
    for norm in (True, False):
        ours = tsp.resynthesize(_t(mag), _t(noisy), ts, ts.inverse(),
                                normalize_wavs=norm)
        theirs = jsp.resynthesize(jnp.asarray(mag), jnp.asarray(noisy), js,
                                  js.inverse(), normalize_wavs=norm)
        _rel(ours, theirs)
    assert float(ours.abs().max()) > 1.0  # the peaks were not cut


# -- STOI --------------------------------------------------------------------

def test_stoi_loss_matches_jax():
    rng = np.random.default_rng(19)
    t = np.arange(12000) / 16000
    clean = (0.5 * np.sin(2 * np.pi * 300 * t) * (1 + np.sin(
        2 * np.pi * 3 * t)))[None].repeat(2, 0).astype(np.float32)
    clean[:, 5000:5600] = 0.0  # a silent stretch for the frame removal
    pred = clean + 0.1 * rng.standard_normal(clean.shape).astype(np.float32)
    lens = np.array([1.0, 0.8])
    for reduction in ("mean", "batch"):
        theirs = jstoi.stoi_loss(pred, clean, lens, reduction=reduction)
        np.testing.assert_allclose(
            tstoi.stoi_loss(pred, clean, lens, reduction=reduction), theirs,
            atol=STOI_ATOL)
        np.testing.assert_allclose(
            tstoi.stoi_loss(torch.from_numpy(pred)[..., None],
                            torch.from_numpy(clean)[..., None],
                            torch.from_numpy(lens), reduction=reduction),
            theirs, atol=STOI_ATOL)
    assert -0.99 < float(tstoi.stoi_loss(pred, clean, lens)) < -0.3


# -- models ------------------------------------------------------------------

def test_wave_fcn_mapper_matches_jax():
    x = _x((2, 90), seed=20)
    _check(jse.WaveFCNMapper(base_channels=4, num_blocks=2, kernel_size=7),
           tse.WaveFCNMapper(4, 2, 7, device="cpu"), x)
    _check(jse.WaveFCNMapper(base_channels=4, num_blocks=1, kernel_size=5),
           tse.WaveFCNMapper(4, 1, 5, device="cpu"), x[..., None])


def test_blstm_masker_matches_jax():
    x = np.abs(_x((2, 9, 17), seed=21))
    _check(jse.BLSTMMasker(n_freq=17, hidden_size=8, lin_size=12),
           tse.BLSTMMasker(17, 8, 2, 12, device="cpu"), x)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fcn2d_maskers_match_jax(train):
    """The 2-D FCN's and FCN+BLSTM's flattened (freq x channel) maps meet
    their projections' weights in flax's order; in training mode the
    BatchNorm statistics move as flax's."""
    x = np.abs(_x((2, 7, 17), seed=22))
    fcn = dict(n_freq=17, base_channels=4, num_blocks=2,
               kernel_size=(3, 5))
    _check(jse.FCN2DMasker(**fcn), tse.FCN2DMasker(**fcn, device="cpu"), x,
           train=train)
    both = dict(fcn, hidden_size=8, lin_size=12)
    _check(jse.FCN2DBLSTMMasker(**both),
           tse.FCN2DBLSTMMasker(**both, device="cpu"), x, train=train)


@pytest.mark.parametrize("causal", [True, False])
def test_cnn_transformer_se_matches_jax(causal):
    x = np.abs(_x((2, 12, 20), seed=23))
    kw = dict(d_model=16, num_layers=2, nhead=4, d_ffn=32, output_size=20,
              causal=causal, output_activation="sigmoid")
    _check(JaxCNNTransformerSE(**kw), CNNTransformerSE(**kw, device="cpu"),
           x)


def test_cnn_transformer_se_custom_embedding_matches_jax():
    x = _x((2, 12, 10), seed=24)
    kw = dict(d_model=16, num_layers=1, nhead=2, d_ffn=32, output_size=20)
    _check(JaxCNNTransformerSE(custom_emb_module=JaxLinear(8), **kw),
           CNNTransformerSE(custom_emb_module=Linear(8, 10, device="cpu"),
                            input_size=8, device="cpu", **kw), x)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_enhance_resnet_matches_jax(train):
    x = np.abs(_x((2, 10, 8), seed=25))
    _check(JaxEnhanceResnet(channels=(4, 8), blocks_per_stage=1),
           EnhanceResnet(8, channels=(4, 8), blocks_per_stage=1,
                         device="cpu"), x, train=train)


# -- interfaces --------------------------------------------------------------

def test_spectral_mask_enhancement_matches_jax(tmp_path):
    """16 kHz, ``n_fft`` 512 and 32 ms windows (the window fills the
    frame): the whole ``enhance_batch`` and ``enhance_file``."""
    kw = dict(n_fft=512, win_length=32, hop_length=16)
    net = dict(d_model=16, num_layers=1, nhead=2, d_ffn=32, output_size=257,
               output_activation="sigmoid", causal=True)
    noisy = 0.5 * _x((2, 4000), seed=26)
    jm, tm = JaxCNNTransformerSE(**net), CNNTransformerSE(**net,
                                                         device="cpu")
    variables = draw_variables(jm, jnp.zeros((1, 26, 257)))
    load(tm, variables)
    js = jfeatures.STFT(16000, backend="rfft", **kw)
    theirs = JaxSpectralMask(
        modules={"enhance_model": jm},
        hparams={"compute_stft": js, "compute_istft": js.inverse()},
        params={"enhance_model": _jax(variables["params"])})
    ts = tfeatures.STFT(16000, device="cpu", **kw)
    ours = SpectralMaskEnhancement(
        modules={"enhance_model": tm},
        hparams={"compute_stft": ts, "compute_istft": ts.inverse()},
        run_opts={"device": "cpu"})
    ref = jax.jit(theirs.enhance_batch)(jnp.asarray(noisy))
    _rel(ours.enhance_batch(_t(noisy)), ref)
    path = tmp_path / "noisy.wav"
    write_audio(path, noisy[0], 16000)
    from_file = ours.enhance_file(path, tmp_path / "out.wav")
    assert torch.equal(from_file, ours.enhance_batch(
        ours.load_audio(path)[None])[0])
    assert (tmp_path / "out.wav").stat().st_size > 8000


def test_waveform_enhancement_matches_jax(tmp_path):
    noisy = 0.5 * _x((2, 700), seed=27)
    jm = jse.WaveFCNMapper(base_channels=4, num_blocks=2, kernel_size=9)
    tm = tse.WaveFCNMapper(4, 2, 9, device="cpu")
    variables = draw_variables(jm, jnp.asarray(noisy))
    load(tm, variables)
    theirs = JaxWaveform(modules={"enhance_model": jm},
                         params={"enhance_model": _jax(variables["params"])})
    ours = WaveformEnhancement(modules={"enhance_model": tm},
                               run_opts={"device": "cpu"})
    _rel(ours.enhance_batch(_t(noisy)),
         jax.jit(theirs.enhance_batch)(jnp.asarray(noisy)))
    path = tmp_path / "noisy.wav"
    write_audio(path, noisy[1], 16000)
    assert torch.equal(ours.enhance_file(path), ours.enhance_batch(
        ours.load_audio(path)[None])[0])


# -- C47 ---------------------------------------------------------------------

def _recording(cls):
    class Recording(cls):
        def on_stage_end(self, stage, stage_loss, epoch=None):
            self.stage_losses = getattr(self, "stage_losses", {})
            self.stage_losses[stage.name] = float(stage_loss)
    return Recording


def test_c47_a_stage_with_no_finite_loss_reports_nan():
    """Every loss of a TRAIN and a VALID stage NaN (and of ``evaluate``):
    JAX reports 0.0 a stage, the port NaN."""
    import optax

    data = _data(n=4, nan_at=(0, 1, 2, 3))
    opts = {"noprogressbar": True, "nonfinite_patience": 10}
    j = _recording(JaxTiny)(modules={}, opt_class=lambda: optax.sgd(0.1),
                            hparams={}, run_opts=opts)
    j.fit(JaxEpochCounter(1), _dataset(JaxDataset, data),
          _dataset(JaxDataset, data),
          train_loader_kwargs={"batch_size": 1},
          valid_loader_kwargs={"batch_size": 1})
    for k in (1, 2):
        t = _recording(Tiny)(
            modules={"lin": _linear()},
            opt_class=lambda p: torch.optim.SGD(p, lr=0.1),
            run_opts={"device": "cpu", "loss_sync_interval": k, **opts})
        t.fit(EpochCounter(1), _dataset(DynamicItemDataset, data),
              _dataset(DynamicItemDataset, data),
              train_loader_kwargs={"batch_size": 1},
              valid_loader_kwargs={"batch_size": 1})
        assert j.stage_losses == {"TRAIN": 0.0, "VALID": 0.0}
        assert set(t.stage_losses) == {"TRAIN", "VALID"}
        assert all(math.isnan(v) for v in t.stage_losses.values())
        assert math.isnan(t.evaluate(_dataset(DynamicItemDataset, data),
                                     test_loader_kwargs={"batch_size": 1}))
    # one finite loss is enough for a number
    mixed = _data(n=4, nan_at=(0, 2))
    t.fit(EpochCounter(1), _dataset(DynamicItemDataset, mixed),
          _dataset(DynamicItemDataset, mixed),
          train_loader_kwargs={"batch_size": 1},
          valid_loader_kwargs={"batch_size": 1})
    assert math.isfinite(t.stage_losses["TRAIN"])
    assert math.isfinite(t.stage_losses["VALID"])


def test_c47_checkpoints_pass_over_a_nan_key(tmp_path):
    lin = torch.nn.Linear(2, 2)
    ckpt = Checkpointer(tmp_path, {"lin": lin})
    for loss in (2.0, 1.5, float("nan")):
        ckpt.save_checkpoint(meta={"loss": loss, "acc": -loss})
    assert ckpt.find_checkpoint(min_key="loss").meta["loss"] == 1.5
    assert ckpt.find_checkpoint(max_key="acc").meta["acc"] == -1.5
    assert [c.meta["loss"] for c in ckpt.find_checkpoints(
        min_key="loss")][:2] == [1.5, 2.0]
    ckpt.save_and_keep_only(meta={"loss": float("nan")}, keep_recent=False,
                            min_keys=["loss"])
    kept = [c.meta["loss"] for c in ckpt.list_checkpoints()]
    assert kept == [1.5]
    assert ckpt.recover_if_possible(min_key="loss").meta["loss"] == 1.5
    # with no number to prefer, a NaN checkpoint is still found
    only = Checkpointer(tmp_path / "only", {"lin": lin})
    only.save_checkpoint(meta={"loss": float("nan")})
    assert math.isnan(only.find_checkpoint(min_key="loss").meta["loss"])
