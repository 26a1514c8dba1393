"""Classification interfaces (port of
``speechbrain_tpu/inference/classifiers.py``: ``EncoderClassifier`` and
``AudioClassifier``).

Each runs under ``torch.no_grad()`` on the interface's device (the card
unless ``run_opts`` ask otherwise), with the modules in ``eval()`` mode.

``encode_batch`` hands the relative lengths to the embedding model, as the
JAX interface does (``classifiers.py:33-35``). There that raises
``TypeError`` on each encoder of the sound-classification recipes
(``Cnn14``, ``ViTEncoder``, ``FocalNetEncoder``, ``Conv2dEncoder_v2``),
which take none (ROADMAP C42). The port's recipes export their encoder
wrapped with their pooling (``PooledEncoder``, which takes ``lengths`` and
ignores them, as the recipes pool unmasked), one vector a clip, which
this interface then serves unchanged.
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


class EncoderClassifier(Pretrained):
    """Features -> embedding model -> classifier.

    hparams: ``compute_features`` (waveforms -> features), optionally
    ``mean_var_norm`` (``(feats, lengths) -> feats``) and
    ``label_encoder``; modules: ``embedding_model`` (``(feats,
    lengths=) -> (B, 1, D)``) and ``classifier``.
    """

    MODULES_NEEDED = ["embedding_model", "classifier"]

    @torch.no_grad()
    def encode_batch(self, wavs, wav_lens=None, normalize=False):
        """(B, T) or (T,) waveforms with relative lengths (all 1 where
        none are given) -> (B, 1, D) embeddings, L2-normalised if
        ``normalize``."""
        if wavs.ndim == 1:
            wavs = wavs[None]
        wavs = wavs.to(self.device)
        if wav_lens is None:
            wav_lens = torch.ones(wavs.shape[0], device=self.device)
        wav_lens = wav_lens.to(self.device)
        feats = self.hparams.compute_features(wavs)
        mean_var_norm = getattr(self.hparams, "mean_var_norm", None)
        if mean_var_norm:
            feats = mean_var_norm(feats, wav_lens)
        embeddings = self.mods.embedding_model(feats, lengths=wav_lens)
        if normalize:
            embeddings = embeddings / torch.linalg.vector_norm(
                embeddings, dim=-1, keepdim=True).clamp(min=1e-12)
        return embeddings

    @torch.no_grad()
    def classify_batch(self, wavs, wav_lens=None):
        """-> ``(out_prob, score, index, text_lab)``: the classifier's
        (B, classes) output, its best value and index a row, and the
        index's label where a ``label_encoder`` holds labels (else
        None)."""
        emb = self.encode_batch(wavs, wav_lens)
        out_prob = self.mods.classifier(emb)
        if out_prob.ndim == 3:
            out_prob = out_prob[:, 0, :]
        score, index = out_prob.max(dim=-1)
        text_lab = None
        encoder = getattr(self.hparams, "label_encoder", None)
        if encoder is not None and len(getattr(encoder, "ind2lab", {})):
            text_lab = encoder.decode_ndim(index)
        return out_prob, score, index, text_lab

    def classify_file(self, path, **kwargs):
        """``classify_batch`` of one audio file (resampled to the model's
        rate)."""
        return self.classify_batch(self.load_audio(path)[None])


class AudioClassifier(EncoderClassifier):
    """Audio tagging with the same interface as
    :class:`EncoderClassifier`."""
