"""Speech-enhancement interfaces (port of
``speechbrain_tpu/inference/enhancement.py``: ``SpectralMaskEnhancement``
and ``WaveformEnhancement``; ``SGMSEEnhancement`` waits for its U-Net).

Each runs under ``torch.no_grad()`` on the interface's device (the card
unless ``run_opts`` ask otherwise), with the modules in ``eval()`` mode.
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained
from speechbrain_tpu_torch.processing.signal_processing import resynthesize


def _write(path, wav, sample_rate):
    from speechbrain_tpu_torch.dataio.dataio import write_audio

    write_audio(path, wav.float().cpu().numpy(), sample_rate)


class SpectralMaskEnhancement(Pretrained):
    """Mask-based spectral enhancement: ``log1p`` magnitudes of
    ``compute_stft`` -> ``enhance_model``'s mask -> ``expm1`` of the
    masked features -> ``resynthesize`` with the noisy phase through
    ``compute_istft``.

    hparams: ``compute_stft``, ``compute_istft`` (and ``sample_rate`` for
    ``enhance_file``, 16000 where none is given); modules:
    ``enhance_model``.
    """

    HPARAMS_NEEDED = ["compute_stft", "compute_istft"]
    MODULES_NEEDED = ["enhance_model"]

    def compute_features(self, wavs):
        """``log1p(sqrt(|STFT|^2 + 1e-14))`` of (batch, time) waveforms."""
        feats = self.hparams.compute_stft(wavs)
        feats = torch.sqrt(feats.real ** 2 + feats.imag ** 2 + 1e-14)
        return torch.log1p(feats)

    @torch.no_grad()
    def enhance_batch(self, noisy, lengths=None):
        """(batch, time) noisy waveforms -> (batch, time) enhanced ones,
        each divided by ``max(peak, 1)``. ``lengths`` are accepted and
        not read, as in the JAX package."""
        noisy_features = self.compute_features(noisy)
        mask = self.mods.enhance_model(noisy_features)
        enhanced_mag = torch.expm1(noisy_features * mask)
        return resynthesize(enhanced_mag, noisy, self.hparams.compute_stft,
                            self.hparams.compute_istft)

    def enhance_file(self, path, output_path=None):
        """One file (mono, resampled to ``sample_rate``) -> its enhanced
        (time,) waveform, written to ``output_path`` where given."""
        enhanced = self.enhance_batch(self.load_audio(path)[None])[0]
        if output_path is not None:
            _write(output_path, enhanced,
                   getattr(self.hparams, "sample_rate", 16000))
        return enhanced


class WaveformEnhancement(Pretrained):
    """Waveform-to-waveform enhancement: ``enhance_model`` maps (batch,
    time) noisy waveforms to enhanced ones.

    modules: ``enhance_model``.
    """

    MODULES_NEEDED = ["enhance_model"]

    @torch.no_grad()
    def enhance_batch(self, noisy, lengths=None):
        """(batch, time) -> (batch, time); ``lengths`` are not read."""
        return self.mods.enhance_model(noisy)

    def enhance_file(self, path, output_path=None):
        """One file -> its enhanced (time,) waveform, written at 16 kHz to
        ``output_path`` where given."""
        enhanced = self.enhance_batch(self.load_audio(path)[None])[0]
        if output_path is not None:
            _write(output_path, enhanced, 16000)
        return enhanced
