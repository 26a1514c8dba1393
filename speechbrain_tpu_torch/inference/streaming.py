"""Streaming ASR inference (port of ``speechbrain_tpu/inference/streaming.py``):
``StreamingASR`` transcribes chunk by chunk, carrying the feature
extractor's, the encoder's and the decoder's state from one chunk to the
next; its audio comes from a file, from any iterator of waveform chunks
(``transcribe_stream``), from a binary file object (``pcm_stream``) or
through an ``ffmpeg`` process (``ffmpeg_audio_stream``).

The interface is the JAX package's hparams contract: ``sample_rate``,
``make_streaming_context(batch, dynchunktrain_config)``,
``encode_chunk(features, encoder context) -> (states, encoder context)``,
``decode_chunk(states, decoder context) -> (token ids a row, decoder
context)``, a ``tokenizer`` with ``decode_ids``, and optionally a
``fea_streaming_extractor`` (a ``StreamingFeatureWrapper``) with the
``frontend_stride`` of the frames it feeds the encoder. Chunks go to the
interface's device (``run_opts["device"]``, ``"cuda"`` unless asked) as
contiguous float32 tensors.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from speechbrain_tpu_torch.inference.interfaces import Pretrained


@dataclass
class ASRStreamingContext:
    """Streaming state: the chunk configuration and each stage's
    context (the tokenizer's is the text so far, a string a row)."""

    config: Any
    fea_extractor_context: Any = None
    encoder_context: Any = None
    decoder_context: Any = None
    tokenizer_context: Any = None


class StreamingASR(Pretrained):
    """Chunk-by-chunk transcription (hparams above).

    Example
    -------
    >>> from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
    ...     DynChunkTrainConfig)
    >>> class Letters:
    ...     def decode_ids(self, ids):
    ...         return "".join(chr(97 + i) for i in ids)
    >>> asr = StreamingASR(hparams={
    ...     "sample_rate": 16000, "tokenizer": Letters(),
    ...     "make_streaming_context": lambda batch, config: 0,
    ...     "encode_chunk": lambda x, n: (n, n + 1),
    ...     "decode_chunk": lambda n, ctx: ([[n]], ctx),
    ... }, run_opts={"device": "cpu"})
    >>> config = DynChunkTrainConfig(chunk_size=2)
    >>> list(asr.transcribe_stream([np.zeros(700)], config))
    ['a', ' b', ' c']
    """

    HPARAMS_NEEDED = ["sample_rate", "make_streaming_context",
                      "encode_chunk", "decode_chunk"]

    def make_streaming_context(self, dynchunktrain_config, batch=1):
        """The state before a stream's first chunk, for ``batch`` streams
        decoded together."""
        ctx = ASRStreamingContext(config=dynchunktrain_config)
        ctx.encoder_context = self.hparams.make_streaming_context(
            batch, dynchunktrain_config)
        if hasattr(self.hparams, "fea_streaming_extractor"):
            ctx.fea_extractor_context = (
                self.hparams.fea_streaming_extractor.make_streaming_context(
                    batch))
        ctx.tokenizer_context = [""] * batch
        return ctx

    def get_chunk_size_frames(self, dynchunktrain_config):
        """Audio samples a chunk: the chunk's encoder frames times the
        feature extractor's stride times the front end's."""
        fea = getattr(self.hparams, "fea_streaming_extractor", None)
        if fea is not None:
            props = fea.get_filter_properties()
            return dynchunktrain_config.chunk_size * props.stride * (
                getattr(self.hparams, "frontend_stride", 1))
        return dynchunktrain_config.chunk_size * getattr(
            self.hparams, "samples_per_frame", 160)

    @torch.no_grad()
    def transcribe_chunk(self, context, chunk, chunk_len=None):
        """One chunk of audio ``(batch, samples)`` or ``(samples,)``
        through the features, the encoder and the decoder; returns each
        row's new text (with a space before it where it follows earlier
        text). ``chunk_len`` is the JAX package's argument and is not
        read."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        if chunk.ndim == 1:
            chunk = chunk[None]
        chunk = chunk.contiguous()
        if hasattr(self.hparams, "fea_streaming_extractor"):
            feats, context.fea_extractor_context = (
                self.hparams.fea_streaming_extractor(
                    chunk, context.fea_extractor_context))
        else:
            feats = chunk
        enc, context.encoder_context = self.hparams.encode_chunk(
            feats, context.encoder_context)
        tokens, context.decoder_context = self.hparams.decode_chunk(
            enc, context.decoder_context)
        texts = []
        for b, toks in enumerate(tokens):
            piece = self.hparams.tokenizer.decode_ids(toks) if toks else ""
            if piece:
                prev = context.tokenizer_context[b]
                sep = " " if prev and not piece.startswith(" ") else ""
                context.tokenizer_context[b] = prev + sep + piece
                texts.append(sep + piece)
            else:
                texts.append("")
        return texts

    def transcribe_stream(self, chunks, dynchunktrain_config):
        """Yield the new text of each streaming chunk for any iterator of
        1-D waveform pieces (a live source too): pieces are gathered into
        chunks of ``get_chunk_size_frames`` samples, and the tail is
        padded with zeros to a whole chunk."""
        chunk_size = self.get_chunk_size_frames(dynchunktrain_config)
        context = self.make_streaming_context(dynchunktrain_config)
        carry = np.zeros((0,), np.float32)
        for chunk in chunks:
            carry = np.concatenate([carry, np.asarray(chunk, np.float32)])
            while len(carry) >= chunk_size:
                yield self.transcribe_chunk(context, carry[:chunk_size])[0]
                carry = carry[chunk_size:]
        if len(carry):
            tail = np.pad(carry, (0, chunk_size - len(carry)))
            yield self.transcribe_chunk(context, tail)[0]

    def transcribe_file_streaming(self, path, dynchunktrain_config,
                                  use_ffmpeg_streaming=False, **kwargs):
        """Yield the new text of each chunk of a file (read whole, padded
        with zeros to whole chunks), or of any URI ``ffmpeg`` reads with
        ``use_ffmpeg_streaming``."""
        chunk_size = self.get_chunk_size_frames(dynchunktrain_config)
        if use_ffmpeg_streaming:
            src = ffmpeg_audio_stream(
                path, chunk_size,
                sample_rate=getattr(self.hparams, "sample_rate", 16000))
            yield from self.transcribe_stream(src, dynchunktrain_config)
            return
        audio = self.load_audio(path)
        context = self.make_streaming_context(dynchunktrain_config)
        n_chunks = -(-audio.shape[0] // chunk_size)
        audio = F.pad(audio, (0, n_chunks * chunk_size - audio.shape[0]))
        for i in range(n_chunks):
            chunk = audio[i * chunk_size:(i + 1) * chunk_size]
            yield self.transcribe_chunk(context, chunk)[0]

    def transcribe_file(self, path, dynchunktrain_config=None, **kwargs):
        """A whole file's text through the streaming path (the hparams'
        ``chunk_size`` and ``left_context_chunks``, 16 and 4 where they
        name none, without a configuration)."""
        if dynchunktrain_config is None:
            from speechbrain_tpu_torch.utils.dynamic_chunk_training import (
                DynChunkTrainConfig,
            )

            dynchunktrain_config = DynChunkTrainConfig(
                chunk_size=getattr(self.hparams, "chunk_size", 16),
                left_context_size=getattr(self.hparams,
                                          "left_context_chunks", 4))
        pieces = list(self.transcribe_file_streaming(path,
                                                     dynchunktrain_config))
        return "".join(pieces).strip()


def pcm_stream(fileobj, frames_per_chunk, dtype="<f4"):
    """Mono PCM chunks of ``frames_per_chunk`` samples (the last may be
    shorter) as float32 numpy arrays, from any binary file object (a
    socket, a pipe, an open file), whatever sizes its reads return."""
    itemsize = np.dtype(dtype).itemsize
    want = frames_per_chunk * itemsize
    buf = b""
    while True:
        data = fileobj.read(want - len(buf))
        if not data:
            break
        buf += data
        if len(buf) >= want:
            yield np.frombuffer(buf[:want], dtype=dtype).astype(np.float32)
            buf = buf[want:]
    if buf:
        n = len(buf) // itemsize * itemsize
        if n:
            yield np.frombuffer(buf[:n], dtype=dtype).astype(np.float32)


def ffmpeg_audio_stream(uri, frames_per_chunk, sample_rate=16000):
    """Decode anything ``ffmpeg`` reads (files, network streams, capture
    devices) into mono float32 chunks at ``sample_rate``, through an
    ``ffmpeg`` process. Raises ``RuntimeError`` where the ``ffmpeg``
    binary is not on the PATH."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg binary not found on PATH; live-stream sources need "
            "it. File transcription works without it via "
            "transcribe_file_streaming(use_ffmpeg_streaming=False)."
        )
    proc = subprocess.Popen(
        ["ffmpeg", "-nostdin", "-loglevel", "error", "-i", str(uri),
         "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1",
         "-ar", str(sample_rate), "pipe:1"],
        stdout=subprocess.PIPE,
    )
    try:
        yield from pcm_stream(proc.stdout, frames_per_chunk)
    finally:
        proc.stdout.close()
        proc.wait()
