"""STOI (short-time objective intelligibility) as a loss (port of
``speechbrain_tpu/nnet/loss/stoi_loss.py``): the 1/3-octave-band
temporal-envelope correlation between clean and enhanced waveforms,
returned as ``-STOI`` so that lower is better.

Host-side numpy in float64, without a gradient, exactly as the JAX
package computes it: its use is scoring (MetricGAN-U's targets and the
enhancement recipes' tables), and its silent-frame removal and per-length
trimming are dynamic in shape. Inputs may be tensors (on any device) or
arrays. The 16 kHz -> 10 kHz resampler is torchaudio's hann-windowed sinc
kernel (``lowpass_filter_width=6``, ``rolloff=0.99``).
"""

import math

import numpy as np

smallVal = np.finfo("float").eps


def _sinc_resample(x, orig_freq=16000, new_freq=10000,
                   lowpass_filter_width=6, rolloff=0.99):
    """torchaudio-equivalent sinc_interp_hann resampling of a 1-D array."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    base = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (-np.arange(new)[:, None] / new + idx[None, :]) * base
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base / orig)
    L = len(x)
    xp = np.pad(np.asarray(x, np.float64), (width, width + orig))
    target_len = int(math.ceil(new * L / orig))
    n_blocks = (len(xp) - kernel.shape[1]) // orig + 1
    out = np.empty((new, n_blocks), np.float64)
    for p in range(new):
        k = kernel[p]
        out[p] = np.correlate(xp, k, mode="valid")[::orig][:n_blocks]
    return out.T.reshape(-1)[:target_len].astype(np.float32)


def thirdoct(fs, nfft, num_bands, min_freq):
    """1/3-octave band analysis matrix (num_bands, nfft // 2 + 1)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = int(np.argmin(np.square(f - freq_low[i])))
        fh_ii = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl_ii:fh_ii] = 1
    return obm


def removeSilentFrames(x, y, dyn_range=40, N=256, K=128):
    """Drop 50%-overlap frames more than ``dyn_range`` dB below the peak
    and overlap-add the survivors."""
    w = np.hanning(N)
    n1 = len(x) // N
    n2 = (len(x) - K) // N
    X = np.zeros((N, n1 + n2))
    X[:, 0::2] = x[: n1 * N].reshape(n1, N).T
    X[:, 1::2] = x[K : n2 * N + K].reshape(n2, N).T
    energy = 20 * np.log10(np.sqrt((w**2) @ (X**2)) / 16.0 + smallVal)
    msk = energy - energy.max() + dyn_range > 0
    Y = np.zeros((N, n1 + n2))
    Y[:, 0::2] = y[: n1 * N].reshape(n1, N).T
    Y[:, 1::2] = y[K : n2 * N + K].reshape(n2, N).T
    x_sil = w[:, None] * X[:, msk]
    y_sil = w[:, None] * Y[:, msk]

    def ola(frames):
        return np.concatenate([
            frames[:K, 0],
            (frames[:K, 1:] + frames[K:, :-1]).T.reshape(-1),
            frames[K:N, -1],
        ])

    return ola(x_sil), ola(y_sil)


def _spectrogram(x, n_fft=512, win_length=256, hop_length=128):
    """|STFT|^2 with a centered hann window (torchaudio Spectrogram
    defaults: reflect pad, window zero-padded to n_fft)."""
    w = np.hanning(win_length + 1)[:-1]
    pad = n_fft // 2
    xp = np.pad(x, pad, mode="reflect")
    win = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    win[off : off + win_length] = w
    n_frames = 1 + (len(xp) - n_fft) // hop_length
    frames = np.lib.stride_tricks.as_strided(
        xp, (n_frames, n_fft), (xp.strides[0] * hop_length, xp.strides[0])
    )
    spec = np.fft.rfft(frames * win, n=n_fft, axis=1)
    return (np.abs(spec) ** 2).T  # (freq, time)


_OBM = thirdoct(fs=10000, nfft=512, num_bands=15, min_freq=150)


def _host(x):
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def stoi_loss(y_pred_batch, y_true_batch, lens, reduction="mean"):
    """-STOI between enhanced and clean (batch, time[, 1]) waveforms at
    16 kHz, each cut to its relative length ``lens``; the batch mean
    (``reduction="mean"``) or one value an utterance, float32.

    Example
    -------
    >>> import numpy as np
    >>> a = np.sin(np.arange(16000, dtype=np.float32))[None]
    >>> b = a + 0.001
    >>> round(float(-stoi_loss(b, a, np.ones(1))), 2)
    0.78
    """
    y_pred_batch = np.asarray(_host(y_pred_batch), np.float64)
    y_true_batch = np.asarray(_host(y_true_batch), np.float64)
    if y_pred_batch.ndim == 3:
        y_pred_batch = y_pred_batch[..., 0]
        y_true_batch = y_true_batch[..., 0]
    lens = _host(lens)
    N = 30  # temporal envelope length
    J = 15.0  # number of bands
    c = 5.62341325  # 10^(-Beta/20), Beta = -15
    D = np.zeros(y_pred_batch.shape[0])
    for i in range(y_pred_batch.shape[0]):
        L = int(lens[i] * y_pred_batch.shape[1])
        y_true = _sinc_resample(y_true_batch[i, :L])
        y_pred = _sinc_resample(y_pred_batch[i, :L])
        y_sil_true, y_sil_pred = removeSilentFrames(y_true, y_pred)
        oct_true = np.sqrt(_OBM @ _spectrogram(y_sil_true) + 1e-14)
        oct_pred = np.sqrt(_OBM @ _spectrogram(y_sil_pred) + 1e-14)
        M = oct_pred.shape[-1] - (N - 1)
        # all envelope windows at once: (M, 15, N)
        X = np.stack([oct_true[:, m : m + N] for m in range(M)])
        Y = np.stack([oct_pred[:, m : m + N] for m in range(M)])
        alpha = np.linalg.norm(X, axis=-1, keepdims=True) / (
            np.linalg.norm(Y, axis=-1, keepdims=True) + smallVal
        )
        ay = Y * alpha
        y = np.minimum(ay, X + X * c)
        xn = X - X.mean(-1, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=-1, keepdims=True) + smallVal)
        yn = y - y.mean(-1, keepdims=True)
        yn = yn / (np.linalg.norm(yn, axis=-1, keepdims=True) + smallVal)
        D[i] = np.sum(xn * yn) / (J * M)
    if reduction == "mean":
        return np.float32(-D.mean())
    return (-D).astype(np.float32)
