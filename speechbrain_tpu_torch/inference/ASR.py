"""Speech recognition interfaces (port of ``EncoderDecoderASR`` and
``EncoderASR`` from ``speechbrain_tpu/inference/ASR.py``; its
``WhisperASR`` and ``SpeechLLMASR`` are not ported yet).

Both transcribe under ``torch.no_grad()`` on the interface's device.
An ``encoder`` may return ``(states, relative lengths)`` instead of the
states alone: an encoder that pads its time axis (``pad_time_to_multiple``
in a ``nnet/containers.LengthsCapableSequential``) rescales the lengths,
and the decoder then gets the rescaled ones, so that its masks and its CTC
lengths cover the same frames as the encoder's.
"""

import torch

from speechbrain_tpu_torch.inference.interfaces import Pretrained


def _split_encoder_output(encoder_out, wav_lens):
    if isinstance(encoder_out, tuple):
        return encoder_out
    return encoder_out, wav_lens


class EncoderDecoderASR(Pretrained):
    """Encoder, then a beam-search decoder, then the tokenizer.

    hparams: ``encoder`` (``(wavs, wav_lens) -> states``), ``decoder`` (a
    searcher, ``(states, lens) -> (hyps, lengths, scores, topk)``),
    ``tokenizer`` (with ``decode_ids``).
    """

    HPARAMS_NEEDED = ["tokenizer"]
    MODULES_NEEDED = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tokenizer = self.hparams.tokenizer

    def transcribe_file(self, path, **kwargs):
        """The words of one audio file (resampled to the model's rate)."""
        waveform = self.load_audio(path)
        rel_length = torch.ones(1, device=self.device)
        predicted_words, _ = self.transcribe_batch(waveform[None],
                                                   rel_length)
        return predicted_words[0]

    @torch.no_grad()
    def encode_batch(self, wavs, wav_lens):
        """The encoder's output for a padded batch: its states, or
        ``(states, lengths)`` for an encoder that rescales lengths."""
        wavs = wavs.to(self.device)
        wav_lens = wav_lens.to(self.device)
        return self.hparams.encoder(wavs, wav_lens)

    @torch.no_grad()
    def transcribe_batch(self, wavs, wav_lens):
        """(B, T) waveforms and relative lengths -> (words of each
        utterance, token ids of each)."""
        encoder_out = self.encode_batch(wavs, wav_lens)
        states, lens = _split_encoder_output(encoder_out,
                                             wav_lens.to(self.device))
        hyps, _lens, _scores, _ = self.hparams.decoder(states, lens)
        predicted_words = [self.tokenizer.decode_ids(tokens)
                           for tokens in hyps]
        return predicted_words, hyps


class EncoderASR(Pretrained):
    """An encoder (with its CTC head), then a decoding function (greedy
    CTC, for one), then the tokenizer: a ``CTCTextEncoder`` joins its
    labels (``decode_ndim``), any other tokenizer decodes ids.

    hparams: ``encoder``, ``decoding_function`` (``(log_probs, lens) ->
    token id lists``), ``tokenizer``.
    """

    HPARAMS_NEEDED = ["tokenizer", "decoding_function"]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tokenizer = self.hparams.tokenizer
        self.decoding_function = self.hparams.decoding_function

    def transcribe_file(self, path, **kwargs):
        waveform = self.load_audio(path)
        rel_length = torch.ones(1, device=self.device)
        predicted_words, _ = self.transcribe_batch(waveform[None],
                                                   rel_length)
        return str(predicted_words[0])

    @torch.no_grad()
    def encode_batch(self, wavs, wav_lens):
        wavs = wavs.to(self.device)
        wav_lens = wav_lens.to(self.device)
        return self.hparams.encoder(wavs, wav_lens)

    @torch.no_grad()
    def transcribe_batch(self, wavs, wav_lens):
        encoder_out = self.encode_batch(wavs, wav_lens)
        states, lens = _split_encoder_output(encoder_out,
                                             wav_lens.to(self.device))
        predictions = self.decoding_function(states, lens)
        if hasattr(self.tokenizer, "decode_ndim"):
            predicted_words = ["".join(self.tokenizer.decode_ndim(seq))
                               for seq in predictions]
        else:
            predicted_words = [self.tokenizer.decode_ids(seq)
                               for seq in predictions]
        return predicted_words, predictions
