"""Spoken language understanding interface (port of
``speechbrain_tpu/inference/SLU.py``: ``EndToEndSLU``): speech -> the
decoded semantics string.

hparams: ``tokenizer`` (with ``decode_ids``), ``slu_enc`` (``(wavs,
relative lengths) -> encoder states``) and ``beam_searcher`` (``(states,
relative lengths) -> (hyps, lengths, scores, topk)``). As in the JAX
interface both are called as they are, not through ``modules``; here
they are ``nn.Module``s that hold their weights (the SLURP direct twin's
``Fbank -> InputNormalization -> CRDNN`` chain and its
``RNNSearchDecoder``), so the interface moves them to its device in
``eval()`` mode like its modules. (The JAX interface calls them outside
``apply``, so a flax module named there, as a YAML names one, is unbound
and raises: its loaded parameters never reach it. ROADMAP C43.)
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


class EndToEndSLU(Pretrained):
    """Direct speech-to-semantics decoding."""

    HPARAMS_NEEDED = ["tokenizer"]
    MODULES_NEEDED = []

    def decode_file(self, path, **kwargs):
        """The decoded semantics of one audio file (resampled to the
        model's rate)."""
        wav = self.load_audio(path)[None]
        words, _ = self.decode_batch(wav, torch.ones(1, device=self.device))
        return words[0]

    @torch.no_grad()
    def encode_batch(self, wavs, wav_lens):
        """(B, T) waveforms with relative lengths -> encoder states."""
        return self.hparams.slu_enc(wavs.to(self.device),
                                    wav_lens.to(self.device))

    @torch.no_grad()
    def decode_batch(self, wavs, wav_lens):
        """-> ``(predicted_words, hyps)``: each row's decoded string and
        its token ids."""
        wav_lens = wav_lens.to(self.device)
        encoder_out = self.encode_batch(wavs, wav_lens)
        hyps, _lens, _scores, _ = self.hparams.beam_searcher(encoder_out,
                                                             wav_lens)
        words = [self.hparams.tokenizer.decode_ids(tokens) for tokens in hyps]
        return words, hyps
