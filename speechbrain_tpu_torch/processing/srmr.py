"""Speech-to-reverberation modulation energy ratio (SRMR), simplified
(port of ``speechbrain_tpu/processing/srmr.py``): the non-intrusive
quality score that MetricGAN-U's discriminator learns to predict. Mel
bands instead of a gammatone filterbank, each band's envelope
modulation energy in 4-20 Hz over that in 20-128 Hz; higher is cleaner
and less reverberant. Host numpy in float64, gradient-free, as upstream
SpeechBrain scores with SRMRpy; tensors are read to the host first.
"""

import numpy as np

from speechbrain_tpu_torch.processing.features import mel_filterbank_matrix


def _host(x):
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def srmr_ratio(wav, sample_rate=16000, n_bands=8):
    """The SRMR-like ratio of one 1-D waveform: its 512-point power
    spectra every 128 samples (Hann), ``n_bands`` mel-band envelopes, and
    the energy of their 4-20 Hz modulations over that of 20-128 Hz.
    Fewer than 8 frames score 0."""
    wav = np.asarray(wav, np.float64)
    n_fft, hop = 512, 128
    n = 1 + max(0, (len(wav) - n_fft)) // hop
    if n < 8:
        return 0.0
    frames = np.lib.stride_tricks.as_strided(
        wav, (n, n_fft), (wav.strides[0] * hop, wav.strides[0]))
    spec = np.abs(np.fft.rfft(frames * np.hanning(n_fft), axis=1)) ** 2
    mel = mel_filterbank_matrix(n_bands, n_fft, sample_rate, 0,
                                sample_rate // 2)
    band_env = spec @ mel  # (frames, n_bands)
    env_rate = sample_rate / hop
    mod = np.abs(np.fft.rfft(band_env - band_env.mean(0, keepdims=True),
                             axis=0)) ** 2
    freqs = np.fft.rfftfreq(band_env.shape[0], d=1.0 / env_rate)
    low = mod[(freqs >= 4) & (freqs < 20)].sum()
    high = mod[(freqs >= 20) & (freqs < 128)].sum()
    return float(low / (high + 1e-10))


def srmr_batch(wavs, lens=None, sample_rate=16000):
    """(batch, time) waveforms, with relative ``lens``, -> (batch,)
    float32 SRMR scores, each over its own length."""
    wavs = _host(wavs)
    lens = None if lens is None else _host(lens)
    out = np.zeros(wavs.shape[0], np.float32)
    for i, w in enumerate(wavs):
        L = int(lens[i] * wavs.shape[1]) if lens is not None \
            else wavs.shape[1]
        out[i] = srmr_ratio(w[:L], sample_rate)
    return out


def srmr_batch_normalized(wavs, lens=None, sample_rate=16000, scale=100.0):
    """``tanh(srmr / scale)``: SRMR in [0, 1), the normalised target
    MetricGAN-U's discriminator regresses."""
    return np.tanh(srmr_batch(wavs, lens, sample_rate) / scale)
