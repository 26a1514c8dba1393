"""Diarization interfaces (port of
``speechbrain_tpu/inference/diarization.py``): frame-level emotion
diarization by a sliding window, and speaker diarization of given
segments by their embeddings and spectral clustering.

Each runs under ``torch.no_grad()`` on the interface's device (the card
unless ``run_opts`` ask otherwise), one window or segment at a time, as
in JAX; the clustering's affinity and eigen-decomposition run on the
host (``alignment/diarization.py``).
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


class Speech_Emotion_Diarization(Pretrained):
    """Emotion segments of a file.

    hparams: optionally ``compute_features`` (waveforms -> features),
    ``sample_rate`` (16000 when absent) and ``label_encoder``; modules:
    ``model`` (features -> (1, frames, classes) logits).
    """

    MODULES_NEEDED = ["model"]

    @torch.no_grad()
    def diarize_file(self, path, window=1.0, stride=0.5):
        """One ``{"start", "end", "emotion"}`` dict a window of ``window``
        seconds every ``stride`` seconds, the last window ending at or
        before the audio's end (JAX stops one window short of it: ROADMAP
        C52); a window's emotion is the argmax of its last frame, decoded
        by ``label_encoder`` where there is one."""
        audio = self.load_audio(path)
        sr = getattr(self.hparams, "sample_rate", 16000)
        win = int(window * sr)
        hop = int(stride * sr)
        compute_features = getattr(self.hparams, "compute_features", None)
        encoder = getattr(self.hparams, "label_encoder", None)
        segments = []
        for start in range(0, max(len(audio) - win + 1, 1), hop):
            chunk = audio[start: start + win][None]
            feats = compute_features(chunk) if compute_features else chunk
            out = self.mods.model(feats)
            idx = int(out.reshape(-1, out.shape[-1])[-1].argmax())
            label = encoder.decode_ind(idx) if encoder is not None else idx
            segments.append(
                {"start": start / sr, "end": (start + win) / sr,
                 "emotion": label})
        return segments


class SpeakerDiarization(Pretrained):
    """Speaker labels of given speech segments: each segment embedded ->
    spectral clustering -> adjacent segments of one speaker merged.

    hparams: optionally ``compute_features`` and ``sample_rate`` (16000
    when absent); modules: ``embedding_model`` (features -> an
    embedding).
    """

    MODULES_NEEDED = ["embedding_model"]

    @torch.no_grad()
    def embed_segments(self, audio, segments):
        """(n, D) float64 numpy embeddings of the ``(start_s, end_s)``
        segments of ``audio`` (T,), one model call a segment."""
        audio = torch.as_tensor(audio).to(self.device)
        sr = getattr(self.hparams, "sample_rate", 16000)
        compute_features = getattr(self.hparams, "compute_features", None)
        embs = []
        for s, e in segments:
            chunk = audio[int(s * sr): int(e * sr)][None]
            feats = compute_features(chunk) if compute_features else chunk
            embs.append(self.mods.embedding_model(feats).reshape(-1))
        return torch.stack(embs).double().cpu().numpy()

    def diarize_segments(self, audio, segments, n_speakers=None):
        """``audio`` (T,), ``segments`` ``[(start_s, end_s)]`` ->
        ``[(start_s, end_s, label)]``, adjacent segments of one label
        merged; the number of speakers is estimated when None."""
        from speechbrain_tpu_torch.alignment.diarization import (
            do_spec_clustering,
            merge_ssegs_same_speaker,
        )

        embs = self.embed_segments(audio, segments)
        labels = do_spec_clustering(embs, n_speakers=n_speakers,
                                    device=self.device)
        return merge_ssegs_same_speaker(
            [(s, e, lab) for (s, e), lab in zip(segments, labels)])
