"""Time-domain processing of waveforms (port of ``Resample`` and
``SpeedPerturb`` from ``speechbrain_tpu/augment/time_domain.py``; its
other perturbations are not ported yet)."""

import math

import numpy as np
import torch
import torch.nn.functional as F


class Resample:
    """Sinc-interpolation resampling from ``orig_freq`` to ``new_freq``:
    after dividing both by their gcd (``orig``, ``new``), each block of
    ``orig`` input samples gives ``new`` output samples, one polyphase
    kernel (a Hann-squared-windowed sinc, cutoff 0.99 of the lower
    Nyquist rate, ``lowpass_filter_width`` zero crossings) per output
    phase. Computes on the waveform's device and dtype.

    Example
    -------
    >>> x = torch.sin(torch.arange(8000) * 2 * math.pi * 440 / 8000)[None]
    >>> Resample(8000, 16000)(x).shape
    torch.Size([1, 16000])
    """

    def __init__(self, orig_freq=16000, new_freq=16000,
                 lowpass_filter_width=6):
        self.orig_freq = orig_freq
        self.new_freq = new_freq
        g = math.gcd(int(orig_freq), int(new_freq))
        self.orig = int(orig_freq) // g
        self.new = int(new_freq) // g
        self.width = lowpass_filter_width
        self._kernel = None

    def _build_kernel(self):
        orig, new = self.orig, self.new
        cutoff = 0.99 * 0.5 * min(1.0, new / orig)
        idx = np.arange(-self.width / cutoff, self.width / cutoff + 1)
        kernels = []
        for phase in range(new):
            frac = phase * orig / new
            t = (idx - (frac - np.floor(frac))) * cutoff
            window = np.where(
                np.abs(t / self.width / cutoff) < 1,
                np.cos(t / self.width / cutoff * np.pi / 2) ** 2,
                0.0,
            )
            kernels.append(np.sinc(t) * window * cutoff)
        return (np.stack(kernels).astype(np.float32),
                int(np.ceil(self.width / cutoff)))

    def __call__(self, waveforms):
        """(B, T) waveforms -> (B, int(T * new / orig))."""
        if self.orig == self.new:
            return waveforms
        if self._kernel is None:
            self._kernel = self._build_kernel()
        kernels, half = self._kernel
        new, K = kernels.shape
        B, T = waveforms.shape[:2]
        x = F.pad(waveforms, (half, half + self.orig))
        n_blocks = T // self.orig + 1
        starts = np.arange(n_blocks) * self.orig
        offsets = np.floor(np.arange(new) * self.orig / new).astype(int)
        idx = (offsets[:, None, None] + starts[None, :, None]
               + np.arange(K)[None, None, :])  # (phase, block, tap)
        idx = torch.from_numpy(np.clip(idx, 0, x.shape[1] - 1)).to(x.device)
        windows = x[:, idx]  # (B, phase, block, tap)
        taps = torch.from_numpy(kernels).to(device=x.device, dtype=x.dtype)
        # phases interleave: output sample block * new + phase
        out = torch.einsum("bpnk,pk->bnp", windows, taps).reshape(B, -1)
        return out[:, :int(T * self.new / self.orig)]


class SpeedPerturb:
    """Speed perturbation by resampling: one of ``speeds`` (percent) is
    drawn a call, the batch resampled from ``orig_freq`` to ``orig_freq *
    speed // 100`` and padded with zeros or cut back to its length.

    The JAX package draws the index with ``jax.random``; here it comes
    from ``generator`` (a ``torch.Generator`` on the CPU), or is given:
    ``branch(waveform, index)`` applies one speed.

    Example
    -------
    >>> sp = SpeedPerturb(16000, speeds=[90, 100, 110])
    >>> sp.branch(torch.zeros(2, 1600), 0).shape
    torch.Size([2, 1600])
    """

    def __init__(self, orig_freq=16000, speeds=(90, 100, 110)):
        self.orig_freq = orig_freq
        self.speeds = list(speeds)
        self.resamplers = [
            Resample(orig_freq=orig_freq, new_freq=orig_freq * s // 100)
            for s in self.speeds
        ]

    def branch(self, waveform, index):
        """``waveform`` (B, T) at ``speeds[index]``, back at T samples."""
        T = waveform.shape[1]
        out = self.resamplers[index](waveform)
        if out.shape[1] >= T:
            return out[:, :T]
        return F.pad(out, (0, T - out.shape[1]))

    def __call__(self, waveform, lengths=None, generator=None):
        index = int(torch.randint(len(self.speeds), (), generator=generator))
        return self.branch(waveform, index)
