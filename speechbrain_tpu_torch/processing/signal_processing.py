"""Low-level signal operations (port of
``speechbrain_tpu/processing/signal_processing.py``): amplitude,
normalisation and rescaling, 1-D convolution (direct or by FFT),
reverberation, the notch filter, overlap-add, resynthesis from a
magnitude and a phase, and Gabor impulse responses.

Each function computes on its input's device; ``notch_filter``, which has
no input tensor, builds on ``device``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate"}


def compute_amplitude(waveforms, lengths=None, amp_type="avg",
                      scale="linear"):
    """Average (``lengths`` in samples divide the sum where given) or peak
    absolute amplitude of (batch, time[, ...]) or (time,) waveforms, keeping
    the time axis as 1; ``scale="dB"`` gives ``max(20 log10(a + 1e-14),
    -80)``.

    Example
    -------
    >>> sig = torch.sin(torch.arange(16000.0))
    >>> bool((compute_amplitude(sig, sig.shape[0]) < 1.0).all())
    True
    """
    if amp_type not in ("avg", "peak"):
        raise ValueError("amp_type must be 'avg' or 'peak'")
    if scale not in ("linear", "dB"):
        raise ValueError("scale must be 'linear' or 'dB'")
    squeeze = waveforms.ndim == 1
    if squeeze:
        waveforms = waveforms[None]
    if amp_type == "avg":
        if lengths is None:
            out = waveforms.abs().mean(dim=1, keepdim=True)
        else:
            out = waveforms.abs().sum(dim=1, keepdim=True) / lengths
    else:
        out = waveforms.abs().amax(dim=1, keepdim=True)
    if scale == "dB":
        out = torch.clamp(20 * torch.log10(out + 1e-14), min=-80.0)
    return out[0] if squeeze else out


def normalize(waveforms, lengths=None, amp_type="avg", eps=1e-14):
    """Waveforms divided by their amplitude (plus ``eps``)."""
    den = compute_amplitude(waveforms, lengths, amp_type) + eps
    return waveforms / den


def rescale(waveforms, lengths, target_lvl, amp_type="avg", scale="linear"):
    """Waveforms normalised, then scaled to ``target_lvl`` (a linear gain,
    or decibels with ``scale="dB"``)."""
    out = normalize(waveforms, lengths, amp_type)
    if scale == "linear":
        return target_lvl * out
    if scale == "dB":
        return dB_to_amplitude(target_lvl) * out
    raise ValueError("scale must be 'linear' or 'dB'")


def dB_to_amplitude(SNR):
    """``10 ** (SNR / 20)``.

    Example
    -------
    >>> dB_to_amplitude(0)
    1.0
    """
    return 10 ** (SNR / 20)


def convolve1d(waveform, kernel, padding=0, pad_type="constant", stride=1,
               groups=1, use_fft=False, rotation_index=0):
    """1-D cross-correlation of (batch, time, channel) waveforms with a
    (out_channels or batch, width, channel) kernel.

    ``padding`` as a pair pads the time axis first (``pad_type``
    ``constant``, ``reflect`` or ``replicate``); as an integer it is the
    direct convolution's zero padding on both sides. With ``use_fft`` the
    product is circular over the waveform's length: the kernel (cut to
    that length) is zero-padded to it and rotated left by
    ``rotation_index`` (an integer or a 0-d tensor, read on the device),
    then multiplied in the frequency domain.

    Example
    -------
    >>> x = torch.ones(1, 8, 1)
    >>> convolve1d(x, torch.ones(1, 3, 1), padding=(1, 1)).shape
    torch.Size([1, 8, 1])
    """
    if isinstance(padding, (list, tuple)):
        x = waveform.transpose(1, 2)
        x = F.pad(x, tuple(padding), mode=_PAD_MODES[pad_type])
        waveform = x.transpose(1, 2)
        padding = 0
    if use_fft:
        T = waveform.shape[1]
        kernel = kernel[:, :T, :]
        kernel = F.pad(kernel, (0, 0, 0, T - kernel.shape[1]))
        # [kernel[rot:] | zeros | kernel[:rot]]: roll left by the rotation
        shift = torch.as_tensor(rotation_index, device=kernel.device)
        idx = torch.remainder(
            torch.arange(T, device=kernel.device) + shift, T)
        kernel = kernel.index_select(1, idx)
        f_sig = torch.fft.rfft(waveform, dim=1)
        f_ker = torch.fft.rfft(kernel, dim=1)
        return torch.fft.irfft(f_sig * f_ker, n=T, dim=1)
    out = F.conv1d(waveform.transpose(1, 2), kernel.permute(0, 2, 1),
                   stride=stride, padding=padding, groups=groups)
    return out.transpose(1, 2)


def reverberate(waveforms, rir_waveform, rescale_amp="avg"):
    """Waveforms (time,), (batch, time) or (batch, time, channel)
    convolved with a room impulse response by FFT, the rotation the
    direct path's index (the largest absolute sample), so that the speech
    stays aligned, then rescaled to their original amplitude.

    Example
    -------
    >>> rir = torch.zeros(1, 50)
    >>> rir[0, 10] = 1.0
    >>> x = torch.randn(1, 400, generator=torch.Generator().manual_seed(0))
    >>> bool(torch.allclose(reverberate(x, rir), x, atol=1e-5))
    True
    """
    orig_ndim = waveforms.ndim
    if waveforms.ndim == 1:
        waveforms = waveforms[None, :, None]
    elif waveforms.ndim == 2:
        waveforms = waveforms[..., None]
    if rir_waveform.ndim == 1:
        rir_waveform = rir_waveform[None, :, None]
    elif rir_waveform.ndim == 2:
        rir_waveform = rir_waveform[..., None]
    orig_amplitude = compute_amplitude(waveforms[..., 0], waveforms.shape[1],
                                       rescale_amp)
    direct_index = rir_waveform.abs().argmax(dim=1).max()
    waveforms = convolve1d(waveforms, rir_waveform, use_fft=True,
                           rotation_index=direct_index)
    rev_amplitude = compute_amplitude(waveforms[..., 0], waveforms.shape[1],
                                      rescale_amp)
    waveforms = waveforms * (orig_amplitude / (rev_amplitude + 1e-14))[
        ..., None]
    if orig_ndim == 1:
        return waveforms[0, :, 0]
    if orig_ndim == 2:
        return waveforms[..., 0]
    return waveforms


def notch_filter(notch_freq, filter_width=101, notch_width=0.05,
                 device="cuda"):
    """FIR notch filter kernel (1, width, 1), float32 on ``device``: a
    Blackman-windowed sinc lowpass below ``notch_freq`` plus a highpass
    above it (frequencies as fractions of the Nyquist rate), built in
    numpy as the JAX package builds it.

    Example
    -------
    >>> notch_filter(0.25, device="cpu").shape
    torch.Size([1, 101, 1])
    """
    pad = filter_width // 2
    inputs = np.arange(filter_width) - pad
    notch_freq += notch_width

    def sinc(x):
        def _sinc(x):
            return np.sin(x) / x

        # the zero is at the middle index
        return np.concatenate([_sinc(x[:pad]), np.ones(1), _sinc(x[pad + 1:])])

    hlpf = sinc(3 * (notch_freq - notch_width) * inputs)
    hlpf *= np.blackman(filter_width)
    hlpf /= np.sum(hlpf)
    hhpf = sinc(3 * (notch_freq + notch_width) * inputs)
    hhpf *= np.blackman(filter_width)
    hhpf /= -np.sum(hhpf)
    hhpf[pad] += 1
    kernel = (hlpf + hhpf).astype(np.float32).reshape(1, -1, 1)
    return torch.from_numpy(kernel).to(device)


def overlap_and_add(signal, frame_step):
    """Rebuild a signal from its frames ``(..., frames, frame_length)``:
    frame ``f`` is added at ``f * frame_step``, giving ``(...,
    (frames - 1) * frame_step + frame_length)``. One ``F.fold`` (col2im:
    each output sample sums the frames over it, with no atomics).

    Example
    -------
    >>> overlap_and_add(torch.ones(2, 3, 4), 2)
    tensor([[1., 1., 2., 2., 2., 2., 1., 1.],
            [1., 1., 2., 2., 2., 2., 1., 1.]])
    """
    frames, frame_length = signal.shape[-2:]
    lead = signal.shape[:-2]
    out_len = (frames - 1) * frame_step + frame_length
    cols = signal.reshape(-1, frames, frame_length).transpose(1, 2)
    out = F.fold(cols, output_size=(1, out_len), kernel_size=(1, frame_length),
                 stride=(1, frame_step))
    return out.reshape(*lead, out_len)


def resynthesize(enhanced_mag, noisy_inputs, stft, istft,
                 normalize_wavs=True):
    """Waveforms from enhanced magnitudes (batch, time, freq) and the
    noisy inputs' phase: ``istft(mag * exp(i * angle(stft(noisy))))`` cut
    to the inputs' length, each divided by ``max(peak, 1)`` where
    ``normalize_wavs``."""
    phase = torch.angle(stft(noisy_inputs))
    complex_predictions = enhanced_mag * torch.exp(1j * phase)
    pred_wavs = istft(complex_predictions, sig_length=noisy_inputs.shape[1])
    if normalize_wavs:
        abs_max = pred_wavs.abs().amax(dim=1, keepdim=True)
        pred_wavs = pred_wavs / torch.clamp(abs_max, min=1.0)
    return pred_wavs


def gabor_impulse_response(t, center, fwhm):
    """Complex Gabor impulse responses (filters, len(t)): a normalised
    Gaussian of each ``fwhm`` times a complex sinusoid of each ``center``
    frequency, complex64."""
    denominator = 1.0 / (math.sqrt(2.0 * math.pi) * fwhm)
    gaussian = torch.exp(torch.outer(1.0 / (2.0 * fwhm ** 2), -(t ** 2)))
    sinusoid = torch.exp(1j * torch.outer(center.to(torch.complex64),
                                          t.to(torch.complex64)))
    return (denominator.to(torch.complex64)[:, None] * sinusoid
            * gaussian.to(torch.complex64))
