"""Test signals made from a seed that show how precise a front end's DFT
is (``ops/mel_frontend.py``): the fused log-mel kernel's checks use them on
the card, its CPU tests against the JAX package."""

import numpy as np


def make_check_signal(kind, batch, samples, seed, noise_db=60.0,
                      sample_rate=16000):
    """(batch, samples) float32 numpy waveforms, made from ``seed``:

    - ``"noise"``: white noise of unit variance;
    - ``"chirp"``: a linear chirp from 300 to 3300 Hz (amplitude 0.5, a
      random phase a row) plus white noise ``noise_db`` below it, so that
      most bins lie far below the loudest;
    - ``"bursts"``: bursts of white noise (0.1 s, levels spread over 40 dB)
      between stretches of digital silence (exact zeros, 0.15 s)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.standard_normal((batch, samples)).astype(np.float32)
    t = np.arange(samples) / sample_rate
    if kind == "chirp":
        dur = samples / sample_rate
        phase = 2 * np.pi * (300.0 * t + (3300.0 - 300.0) * t * t / (2 * dur))
        x = 0.5 * np.sin(phase[None, :] + rng.uniform(0, 2 * np.pi,
                                                       (batch, 1)))
        noise = rng.standard_normal((batch, samples)) * np.sqrt(
            0.125 * 10.0 ** (-noise_db / 10.0)
        )
        return (x + noise).astype(np.float32)
    if kind == "bursts":
        burst, silence = int(0.1 * sample_rate), int(0.15 * sample_rate)
        period = burst + silence
        on = (np.arange(samples) % period) < burst
        level = 10.0 ** rng.uniform(-2, 0, (batch, samples // period + 1))
        gain = np.repeat(level, period, axis=1)[:, :samples] * on[None, :]
        return (rng.standard_normal((batch, samples)) * gain).astype(
            np.float32
        )
    raise ValueError(f"unknown check signal {kind!r}")
