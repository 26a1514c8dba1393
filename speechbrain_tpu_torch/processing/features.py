"""Low-level feature pipeline (port of the part of
``speechbrain_tpu/processing/features.py`` that ``Fbank``, ``MFCC``,
training and enhancement's resynthesis need): windows, framing (zero,
reflect or replicate centre padding), ``STFT`` (one- or two-sided, mono or
multi-channel) with its real power spectrogram, ``ISTFT``, the mel filter
matrix, ``Filterbank`` with dB compression and the per-sequence ``top_db``
clamp, ``spectral_magnitude``, ``DCT``, ``Deltas``, ``ContextWindow``,
``InputNormalization``, ``GlobalNorm``, ``MinLevelNorm`` and
``DynamicRangeCompression``. Constants are built in numpy, exactly as the
JAX package builds them, and moved to the device once.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from speechbrain_tpu_torch.utils.autocast import fwd_default_precision
from speechbrain_tpu_torch.utils.checkpoints import (
    mark_as_loader,
    mark_as_saver,
    register_checkpoint_hooks,
)


def _ms_to_samples(sample_rate, ms):
    return int(round(sample_rate / 1000.0 * ms))


def hamming_window(n, dtype=np.float32):
    """Periodic hamming window matching torch.hamming_window defaults."""
    k = np.arange(n)
    return (0.54 - 0.46 * np.cos(2 * np.pi * k / n)).astype(dtype)


def hann_window(n, dtype=np.float32):
    """Periodic Hann window of given length."""
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * k / n)).astype(dtype)


def blackman_window(n, dtype=np.float32):
    """Periodic Blackman window of given length."""
    k = np.arange(n)
    w = (
        0.42
        - 0.5 * np.cos(2 * np.pi * k / n)
        + 0.08 * np.cos(4 * np.pi * k / n)
    )
    return w.astype(dtype)


_WINDOWS = {
    "hamming": hamming_window,
    "hann": hann_window,
    "blackman": blackman_window,
}


_CENTER_PADS = ("constant", "reflect", "replicate")


def frame_signal(x, frame_length, hop_length, center=True,
                 pad_mode="constant"):
    """Slice a signal (..., time) into frames (..., n_frames,
    frame_length); a strided view of the signal, padded by half a frame on
    both sides when ``center``: with zeros (``"constant"``), the signal
    mirrored about its end samples (``"reflect"``) or its end samples
    repeated (``"replicate"``)."""
    if center:
        pad = (frame_length // 2, frame_length // 2)
        if pad_mode == "constant":
            x = F.pad(x, pad)
        else:
            # F.pad mirrors and repeats along the last axis of 2-D/3-D
            # inputs only
            lead = x.shape[:-1]
            x = F.pad(x.reshape(-1, 1, x.shape[-1]), pad, mode=pad_mode)
            x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, frame_length, hop_length)


class STFT:
    """Short-Term Fourier Transform; returns complex (batch, time, freq),
    or (batch, time, freq, channel) for a multi-channel (batch, samples,
    channel) input. ``win_length`` and ``hop_length`` are in milliseconds;
    a window shorter than ``n_fft`` sits centred in the frame, as
    ``torch.stft`` puts it. ``pad_mode`` pads a centred signal (see
    :func:`frame_signal`); ``onesided=False`` gives all ``n_fft`` bins of
    the full FFT.

    Example
    -------
    >>> stft = STFT(sample_rate=16000, device="cpu")
    >>> stft(torch.zeros(2, 16000)).shape
    torch.Size([2, 101, 201])
    >>> STFT(16000, onesided=False, device="cpu")(torch.zeros(2, 16000, 3)).shape
    torch.Size([2, 101, 400, 3])
    """

    def __init__(self, sample_rate, win_length=25, hop_length=10, n_fft=400,
                 window_fn="hamming", normalized_stft=False, center=True,
                 pad_mode="constant", onesided=True, device="cuda"):
        self.sample_rate = sample_rate
        self.win_length = _ms_to_samples(sample_rate, win_length)
        self.hop_length = _ms_to_samples(sample_rate, hop_length)
        self.n_fft = n_fft
        self.window_fn = window_fn
        self.normalized_stft = normalized_stft
        self.center = center
        if pad_mode not in _CENTER_PADS:
            raise ValueError(f"Unknown pad_mode {pad_mode!r}")
        self.pad_mode = pad_mode
        self.onesided = onesided
        self.window = torch.from_numpy(
            _frame_window(window_fn, self.win_length, n_fft)).to(device)

    def _windowed_frames(self, x):
        frames = frame_signal(x, self.n_fft, self.hop_length, self.center,
                              self.pad_mode)
        return frames * self.window

    def __call__(self, x):
        multi_channel = x.ndim == 3
        if multi_channel:
            x = x.movedim(2, 1)  # (batch, channel, time)
        fft = torch.fft.rfft if self.onesided else torch.fft.fft
        stft = fft(self._windowed_frames(x), n=self.n_fft, dim=-1)
        if self.normalized_stft:
            stft = stft / math.sqrt(self.n_fft)
        return stft.movedim(1, -1) if multi_channel else stft

    def power(self, x):
        """Power spectrogram |STFT|^2, (batch, time, freq[, channel]) real.
        One-sided whatever ``onesided`` says, as the JAX package's."""
        multi_channel = x.ndim == 3
        if multi_channel:
            x = x.movedim(2, 1)
        stft = torch.fft.rfft(self._windowed_frames(x), n=self.n_fft, dim=-1)
        ps = stft.real ** 2 + stft.imag ** 2
        if self.normalized_stft:
            ps = ps / self.n_fft
        return ps.movedim(1, -1) if multi_channel else ps

    def inverse(self):
        """The ``ISTFT`` that inverts this transform: the same rate, frame,
        window (placed as here), hop, normalisation and centring, on the
        window's device. The constructor takes milliseconds where this
        object holds samples; the JAX package's ``inverse`` passes on
        only the rate, ``n_fft`` and the lengths."""
        sr = self.sample_rate
        return ISTFT(sr, n_fft=self.n_fft,
                     win_length=self.win_length * 1000.0 / sr,
                     hop_length=self.hop_length * 1000.0 / sr,
                     window_fn=self.window_fn,
                     normalized_stft=self.normalized_stft,
                     center=self.center, device=self.window.device)

    def get_filter_properties(self):
        """The window (``win_length`` samples) and stride (``hop_length``)
        of a centred STFT, for ``StreamingFeatureWrapper``."""
        from speechbrain_tpu_torch.utils.filter_analysis import (
            FilterProperties,
        )

        if not self.center:
            raise ValueError("Filter properties assume a centered STFT")
        return FilterProperties(window_size=self.win_length,
                                stride=self.hop_length)


def _frame_window(window_fn, win_length, n_fft):
    """The analysis window of ``win_length`` samples (a name in
    ``_WINDOWS`` or a function of the length) as an ``n_fft`` frame, the
    window centred in it where it is shorter, numpy float32."""
    window = (
        _WINDOWS[window_fn](win_length)
        if isinstance(window_fn, str)
        else np.asarray(window_fn(win_length), dtype=np.float32)
    )
    if win_length < n_fft:
        # center the window inside the fft size (torch.stft behaviour)
        left = (n_fft - win_length) // 2
        padded = np.zeros(n_fft, dtype=np.float32)
        padded[left: left + win_length] = window
        window = padded
    return window


class ISTFT:
    """Inverse STFT: the inverse rFFT of each frame times the window,
    overlap-added (``overlap_and_add``, one ``F.fold``) and divided by
    the overlap-added squared window clamped at ``epsilon``; with
    ``center`` the first ``n_fft // 2`` samples are dropped, and the
    result is cut to ``sig_length`` where given. Complex (batch, time,
    freq) -> (batch, samples); (batch, time, freq, channel) -> (batch,
    samples, channel).

    The window sits in the frame where ``STFT`` puts it, centred where
    ``win_length < n_fft``, so that ``ISTFT(STFT(x))`` gives back ``x``
    at any window length. (The JAX package's ``ISTFT`` multiplies the
    first ``win_length`` samples of each frame, which inverts its STFT
    only where the window fills the frame; there the two agree.)

    Example
    -------
    >>> stft = STFT(8000, win_length=32, hop_length=16, n_fft=512,
    ...             device="cpu")
    >>> x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0))
    >>> y = stft.inverse()(stft(x), sig_length=4000)
    >>> bool(((y - x).norm() / x.norm()) < 1e-5)
    True
    """

    def __init__(self, sample_rate, n_fft=400, win_length=25, hop_length=10,
                 window_fn="hamming", normalized_stft=False, center=True,
                 epsilon=1e-12, device="cuda"):
        self.sample_rate = sample_rate
        self.win_length = _ms_to_samples(sample_rate, win_length)
        self.hop_length = _ms_to_samples(sample_rate, hop_length)
        self.n_fft = n_fft
        self.center = center
        self.epsilon = epsilon
        self.normalized_stft = normalized_stft
        self.window = torch.from_numpy(
            _frame_window(window_fn, self.win_length, n_fft)).to(device)

    def __call__(self, stft, sig_length=None):
        from speechbrain_tpu_torch.processing.signal_processing import (
            overlap_and_add,
        )

        multi_channel = stft.ndim == 4
        if multi_channel:
            stft = stft.movedim(-1, 1)
        if self.normalized_stft:
            stft = stft * math.sqrt(self.n_fft)
        frames = torch.fft.irfft(stft, n=self.n_fft, dim=-1) * self.window
        sig = overlap_and_add(frames, self.hop_length)
        env = overlap_and_add(
            (self.window ** 2).expand(frames.shape[-2], -1), self.hop_length)
        sig = sig / torch.clamp(env, min=self.epsilon)
        if self.center:
            sig = sig[..., self.n_fft // 2:]
        if sig_length is not None:
            sig = sig[..., :sig_length]
        return sig.movedim(1, -1) if multi_channel else sig


def spectral_magnitude(stft, power=1, log=False, eps=1e-14):
    """The magnitude of a complex spectrogram, or of one whose last axis
    holds [real, imaginary]: ``power=1`` gives the power spectrogram
    ``|X|^2``, ``power=0.5`` the magnitude (``eps`` is added to ``|X|^2``
    first where ``power < 1``); ``log`` gives ``log(. + eps)``.

    Example
    -------
    >>> spectral_magnitude(torch.tensor([[3.0 + 4.0j]]), power=0.5)
    tensor([[5.]])
    """
    if torch.is_complex(stft):
        spectr = stft.real ** 2 + stft.imag ** 2
    else:
        spectr = (stft ** 2).sum(-1)
    if power < 1:
        spectr = spectr + eps
    spectr = spectr ** power
    if log:
        return torch.log(spectr + eps)
    return spectr


def _to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank_matrix(n_mels=40, n_fft=400, sample_rate=16000,
                          f_min=0.0, f_max=8000.0,
                          filter_shape="triangular", dtype=np.float32):
    """(n_freqs, n_mels) filter matrix (numpy)."""
    n_stft = n_fft // 2 + 1
    mel = np.linspace(_to_mel(f_min), _to_mel(f_max), n_mels + 2)
    hz = _to_hz(mel)
    band = hz[1:] - hz[:-1]
    band = band[:-1][:, None]  # (n_mels, 1)
    f_central = hz[1:-1][:, None]
    all_freqs = np.linspace(0, sample_rate // 2, n_stft)[None, :]
    if filter_shape == "triangular":
        slope = (all_freqs - f_central) / band
        fbank = np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))
    elif filter_shape == "rectangular":
        low = f_central - band
        high = f_central + band
        fbank = ((all_freqs >= low) & (all_freqs <= high)).astype(np.float64)
    elif filter_shape == "gaussian":
        fbank = np.exp(-0.5 * ((all_freqs - f_central) / (band / 2.0)) ** 2)
    else:
        raise ValueError(f"Unknown filter shape {filter_shape}")
    return fbank.T.astype(dtype)  # (n_freqs, n_mels)


class Filterbank:
    """Mel filterbank projection with optional dB compression:
    multiplier 10 for power spectrograms, amin clamp, per-sequence
    top_db.

    Example
    -------
    >>> fb = Filterbank(device="cpu")
    >>> fb(torch.ones(10, 101, 201)).shape
    torch.Size([10, 101, 40])
    """

    def __init__(self, n_mels=40, log_mel=True, filter_shape="triangular",
                 f_min=0.0, f_max=8000.0, n_fft=400, sample_rate=16000,
                 power_spectrogram=2, amin=1e-10, ref_value=1.0, top_db=80.0,
                 device="cuda"):
        self.n_mels = n_mels
        self.log_mel = log_mel
        self.amin = amin
        self.ref_value = ref_value
        self.top_db = top_db
        self.multiplier = 10.0 if power_spectrogram == 2 else 20.0
        self.db_multiplier = math.log10(max(amin, ref_value))
        self.fbank_matrix = torch.from_numpy(
            np.ascontiguousarray(mel_filterbank_matrix(
                n_mels, n_fft, sample_rate, f_min, f_max, filter_shape
            ))
        ).to(device)

    def __call__(self, spectrogram):
        multi_channel = spectrogram.ndim == 4
        if multi_channel:
            spectrogram = spectrogram.movedim(3, 1)
        fbanks = torch.matmul(spectrogram, self.fbank_matrix)
        if self.log_mel:
            fbanks = self._amplitude_to_db(fbanks)
        return fbanks.movedim(1, 3) if multi_channel else fbanks

    def _amplitude_to_db(self, x):
        x_db = self.multiplier * torch.log10(torch.clamp(x, min=self.amin))
        x_db = x_db - self.multiplier * self.db_multiplier
        # per-sequence max over (time, mel), clamp to max - top_db
        maxes = torch.amax(x_db, dim=(-2, -1), keepdim=True)
        return torch.maximum(x_db, maxes - self.top_db)


class DCT:
    """Type-II DCT (ortho-normalised by default) of the last axis, as MFCCs
    take it: ``(..., input_size)`` -> ``(..., n_out)``; a 4-D ``(batch,
    time, feat, channel)`` input is transformed along ``feat``.

    Example
    -------
    >>> DCT(input_size=40, n_out=20, device="cpu")(torch.ones(10, 101, 40)).shape
    torch.Size([10, 101, 20])
    """

    def __init__(self, input_size, n_out=20, ortho_norm=True, device="cuda"):
        if n_out > input_size:
            raise ValueError("n_out cannot exceed input size")
        n = np.arange(float(input_size))
        k = np.arange(float(n_out))
        dct = np.cos(np.pi / input_size * (n[None, :] + 0.5)
                     * k[:, None]) * 2.0
        if ortho_norm:
            dct[0] *= 1.0 / math.sqrt(2.0)
            dct *= math.sqrt(1.0 / (2.0 * input_size))
        self.dct_mat = torch.from_numpy(
            np.ascontiguousarray(dct.T.astype(np.float32))).to(device)

    def __call__(self, x):
        multi_channel = x.ndim == 4
        if multi_channel:
            x = x.movedim(3, 1)
        out = torch.matmul(x, self.dct_mat)
        return out.movedim(1, 3) if multi_channel else out


class Deltas:
    """Time derivatives by the standard regression over ``window_length``
    frames: ``sum_k k * x[t + k] / (2 * sum_k k^2)`` for ``k`` in ``-n..n``,
    the time axis (axis 1) padded by repeating its end frames. Works on
    the input's device; ``input_size`` is accepted for the JAX package's
    signature.

    Example
    -------
    >>> Deltas(input_size=20)(torch.ones(10, 101, 20)).abs().max().item()
    0.0
    """

    def __init__(self, input_size=None, window_length=5):
        self.n = (window_length - 1) // 2
        self.denom = self.n * (self.n + 1) * (2 * self.n + 1) / 3.0

    def __call__(self, x):
        n, T = self.n, x.shape[1]
        xp = torch.cat([x[:, :1].expand(-1, n, *x.shape[2:]), x,
                        x[:, -1:].expand(-1, n, *x.shape[2:])], dim=1)
        out = torch.zeros_like(x)
        # summed in the JAX package's order, k = -n .. n
        for k in range(-n, n + 1):
            if k:
                out = out + k * xp[:, k + n: k + n + T]
        return out / self.denom


class ContextWindow:
    """Each frame concatenated with its ``left_frames`` and
    ``right_frames`` neighbours on the feature axis (axis 2), the time axis
    zero-padded: ``(batch, time, feat[, channel])`` -> ``(batch, time,
    (left + 1 + right) * feat[, channel])``, the earliest frame first.

    Example
    -------
    >>> ContextWindow(2, 2)(torch.ones(10, 101, 20)).shape
    torch.Size([10, 101, 100])
    """

    def __init__(self, left_frames=0, right_frames=0):
        self.left_frames = left_frames
        self.right_frames = right_frames

    def __call__(self, x):
        T = x.shape[1]
        pad = [0, 0] * (x.ndim - 2) + [self.left_frames, self.right_frames]
        xp = F.pad(x, pad)
        return torch.cat(
            [xp[:, k: k + T]
             for k in range(self.left_frames + self.right_frames + 1)],
            dim=2)


@register_checkpoint_hooks
class InputNormalization:
    """Mean and variance normalisation over time, per sentence, over the
    batch, per speaker or with global statistics, the last two kept as
    running averages on the host and checkpointed. Statistics are masked
    by the relative lengths. The ``"speaker"`` type takes the batch's
    speaker ids (``spk_ids``) and reads each sentence's statistics to the
    host, as the JAX package does.

    Example
    -------
    >>> norm = InputNormalization(norm_type="sentence")
    >>> norm(torch.ones(2, 10, 5), torch.ones(2)).shape
    torch.Size([2, 10, 5])
    """

    def __init__(self, mean_norm=True, std_norm=True, norm_type="global",
                 avg_factor=None, update_until_epoch=2, epsilon=1e-10):
        if norm_type not in ("sentence", "batch", "speaker", "global"):
            raise ValueError(f"Unknown norm_type {norm_type}")
        self.mean_norm = mean_norm
        self.std_norm = std_norm
        self.norm_type = norm_type
        self.avg_factor = avg_factor
        self.update_until_epoch = update_until_epoch
        self.epsilon = epsilon
        self.glob_mean = torch.tensor(0.0)
        self.glob_std = torch.tensor(1.0)
        self.count = 0
        self.spk_dict_mean = {}
        self.spk_dict_std = {}
        self.spk_dict_count = {}

    def _masked_moments(self, x, lengths):
        """Per-sentence masked mean and std over time: (B, 1, ...)."""
        T = x.shape[1]
        valid = torch.round(lengths * T)
        mask = (torch.arange(T, device=x.device)[None, :]
                < valid[:, None]).to(x.dtype)
        mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (x * mask).sum(dim=1, keepdim=True) / denom
        var = (((x - mean) ** 2) * mask).sum(dim=1, keepdim=True) / denom
        return mean, torch.sqrt(var + self.epsilon)

    @fwd_default_precision
    def __call__(self, x, lengths, spk_ids=None, epoch=None):
        mean, std = self._masked_moments(x, lengths)
        if not self.mean_norm:
            mean = torch.zeros_like(mean)
        if not self.std_norm:
            std = torch.ones_like(std)
        if self.norm_type == "sentence":
            return (x - mean) / std
        if self.norm_type == "batch":
            return (x - mean.mean(dim=0, keepdim=True)) / std.mean(
                dim=0, keepdim=True
            )
        if self.norm_type == "speaker":
            return self._speaker_norm(x, mean, std, spk_ids)
        if epoch is None or epoch < self.update_until_epoch:
            bmean = mean.mean(dim=0).detach()
            bstd = std.mean(dim=0).detach()
            if self.count == 0:
                self.glob_mean, self.glob_std = bmean, bstd
            else:
                w = (1.0 / (self.count + 1) if self.avg_factor is None
                     else self.avg_factor)
                self.glob_mean = ((1 - w) * self.glob_mean.to(x.device)
                                  + w * bmean)
                self.glob_std = ((1 - w) * self.glob_std.to(x.device)
                                 + w * bstd)
            self.count += 1
        gm = self.glob_mean.to(x.device) if self.mean_norm else 0.0
        gs = self.glob_std.to(x.device) if self.std_norm else 1.0
        return (x - gm) / gs

    def _speaker_norm(self, x, mean, std, spk_ids):
        """Each sentence normalised by its speaker's running statistics,
        updated first with the sentence's own (a running mean, or
        ``avg_factor``'s exponential one), on the host."""
        out = []
        for i, spk in enumerate(list(spk_ids)):
            spk = str(spk)
            m_i = mean[i].detach().cpu()
            s_i = std[i].detach().cpu()
            if spk not in self.spk_dict_mean:
                self.spk_dict_mean[spk] = m_i
                self.spk_dict_std[spk] = s_i
                self.spk_dict_count[spk] = 1
            else:
                c = self.spk_dict_count[spk] + 1
                self.spk_dict_count[spk] = c
                w = 1.0 / c if self.avg_factor is None else self.avg_factor
                self.spk_dict_mean[spk] = ((1 - w) * self.spk_dict_mean[spk]
                                           + w * m_i)
                self.spk_dict_std[spk] = ((1 - w) * self.spk_dict_std[spk]
                                          + w * s_i)
            out.append((x[i] - self.spk_dict_mean[spk].to(x.device))
                       / self.spk_dict_std[spk].to(x.device))
        return torch.stack(out)

    @mark_as_saver
    def _save(self, path):
        torch.save({"glob_mean": self.glob_mean, "glob_std": self.glob_std,
                    "count": self.count,
                    "spk_dict_mean": self.spk_dict_mean,
                    "spk_dict_std": self.spk_dict_std,
                    "spk_dict_count": self.spk_dict_count}, path)

    @mark_as_loader
    def _load(self, path, end_of_epoch=False):
        state = torch.load(path, map_location=self.glob_mean.device,
                           weights_only=True)
        self.glob_mean = state["glob_mean"]
        self.glob_std = state["glob_std"]
        self.count = int(state["count"])
        self.spk_dict_mean = dict(state.get("spk_dict_mean", {}))
        self.spk_dict_std = dict(state.get("spk_dict_std", {}))
        self.spk_dict_count = dict(state.get("spk_dict_count", {}))


class GlobalNorm:
    """Normalise to a target mean and std (``norm_mean``, ``norm_std``)
    from a running mean and std of the whole input, updated on the host
    by every call until ``update_steps`` calls (all calls by default) or
    ``freeze()``; ``denormalize`` inverts it (port of the JAX package's
    ``GlobalNorm``).

    Example
    -------
    >>> norm = GlobalNorm()
    >>> y = norm(torch.tensor([1.0, 3.0]))
    >>> [round(v, 4) for v in y.tolist()], norm.denormalize(y).tolist()
    ([-1.0, 1.0], [1.0, 3.0])
    """

    def __init__(self, norm_mean=0.0, norm_std=1.0, update_steps=None,
                 length_dim=2, mask_value=0.0):
        self.norm_mean = norm_mean
        self.norm_std = norm_std
        self.update_steps = update_steps
        self.mask_value = mask_value
        self.step_count = 0
        self.running_mean = 0.0
        self.running_std = 1.0
        self.frozen = False

    def freeze(self):
        self.frozen = True

    def unfreeze(self):
        self.frozen = False

    def __call__(self, x, lengths=None):
        if not self.frozen and (self.update_steps is None
                                or self.step_count < self.update_steps):
            m = float(x.mean())
            s = float(x.std(unbiased=False))
            w = 1.0 / (self.step_count + 1)
            self.running_mean = (1 - w) * self.running_mean + w * m
            self.running_std = (1 - w) * self.running_std + w * s
            self.step_count += 1
        x = (x - self.running_mean) / (self.running_std + 1e-8)
        return x * self.norm_std + self.norm_mean

    def denormalize(self, x):
        x = (x - self.norm_mean) / self.norm_std
        return x * (self.running_std + 1e-8) + self.running_mean


class MinLevelNorm:
    """Power in dB mapped to [-1, 1] from a floor of ``min_level_db``:
    ``clip((x - min) / -min, 0, 1) * 2 - 1``, and back.

    Example
    -------
    >>> MinLevelNorm(-100.0)(torch.tensor([-100.0, -50.0, 0.0])).tolist()
    [-1.0, 0.0, 1.0]
    """

    def __init__(self, min_level_db):
        self.min_level_db = min_level_db

    def __call__(self, x):
        return torch.clamp((x - self.min_level_db) / -self.min_level_db,
                           0.0, 1.0) * 2.0 - 1.0

    def denormalize(self, x):
        x = torch.clamp(x, -1.0, 1.0)
        return (x + 1.0) / 2.0 * -self.min_level_db + self.min_level_db


class DynamicRangeCompression:
    """``log(max(x, clip_val) * multiplier)``.

    Example
    -------
    >>> DynamicRangeCompression()(torch.tensor([1.0])).tolist()
    [0.0]
    """

    def __init__(self, multiplier=1.0, clip_val=1e-5):
        self.multiplier = multiplier
        self.clip_val = clip_val

    def __call__(self, x):
        return torch.log(torch.clamp(x, min=self.clip_val) * self.multiplier)
