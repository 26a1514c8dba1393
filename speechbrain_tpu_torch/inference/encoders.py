"""Encoder interfaces (port of ``speechbrain_tpu/inference/encoders.py``:
``WaveformEncoder`` and ``MelSpectrogramEncoder``), under
``torch.no_grad()`` on the interface's device.
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


class WaveformEncoder(Pretrained):
    """A raw-waveform ``encoder`` module: ``encoder(wavs)``."""

    MODULES_NEEDED = ["encoder"]

    @torch.no_grad()
    def encode_batch(self, wavs, wav_lens=None):
        """(B, T) waveforms -> the encoder's output (``wav_lens`` are
        accepted and unread, as in the JAX package)."""
        return self.mods.encoder(wavs.to(self.device))

    def encode_file(self, path):
        return self.encode_batch(self.load_audio(path)[None])[0]


class MelSpectrogramEncoder(Pretrained):
    """An ``embedding_model`` over mel spectrograms (B, T, n_mels)."""

    MODULES_NEEDED = ["embedding_model"]

    @torch.no_grad()
    def encode_mel_spectrogram(self, mel):
        """One (T, n_mels) spectrogram, or a batch of them."""
        mel = mel.to(self.device)
        return self.mods.embedding_model(mel[None] if mel.ndim == 2 else mel)

    @torch.no_grad()
    def encode_mel_spectrogram_batch(self, mels, lens=None):
        lens = None if lens is None else lens.to(self.device)
        return self.mods.embedding_model(mels.to(self.device), lengths=lens)

    @torch.no_grad()
    def encode_waveform(self, wav):
        """Waveform(s) -> ``compute_features`` -> ``embedding_model``."""
        wav = wav.to(self.device)
        feats = self.hparams.compute_features(wav[None] if wav.ndim == 1
                                              else wav)
        return self.mods.embedding_model(feats)
