"""Speaker verification (port of ``speechbrain_tpu/inference/speaker.py``:
``SpeakerRecognition``): the cosine similarity of two utterances'
embeddings, held against a threshold.
"""

import torch

from speechbrain_tpu_torch.inference.classifiers import EncoderClassifier


class SpeakerRecognition(EncoderClassifier):
    """An :class:`EncoderClassifier` that needs only ``embedding_model``
    and scores pairs of utterances."""

    MODULES_NEEDED = ["embedding_model"]

    @torch.no_grad()
    def verify_batch(self, wavs1, wavs2, wav1_lens=None, wav2_lens=None,
                     threshold=0.25):
        """-> ``(score, decision)``: the cosine similarity of each pair's
        embeddings (B,) and whether it exceeds ``threshold``."""
        emb1 = self.encode_batch(wavs1, wav1_lens)
        emb2 = self.encode_batch(wavs2, wav2_lens)
        if emb1.ndim == 3:
            emb1, emb2 = emb1[:, 0, :], emb2[:, 0, :]
        num = (emb1 * emb2).sum(dim=-1)
        den = (torch.linalg.vector_norm(emb1, dim=-1)
               * torch.linalg.vector_norm(emb2, dim=-1))
        score = num / den.clamp(min=1e-12)
        return score, score > threshold

    def verify_files(self, path_x, path_y, **kwargs):
        """``(score, decision)`` of two audio files: are they one
        speaker?"""
        score, decision = self.verify_batch(self.load_audio(path_x)[None],
                                            self.load_audio(path_y)[None])
        return score[0], bool(decision[0])
