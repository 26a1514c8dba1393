"""Composed feature extractors (port of ``speechbrain_tpu/lobes/features.py``:
``Fbank``, ``MFCC``, ``upalign_value``, ``Leaf`` and
``StreamingFeatureWrapper``). With ``fused=True`` Fbank's chain up to the
log-mels runs as one hand-written CUDA kernel
(``speechbrain_tpu_torch.ops.mel_frontend``); its deltas and context window
follow in PyTorch.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.ops.mel_frontend import (
    dft_tables,
    fused_fbank,
    kernel_operands,
)
from speechbrain_tpu_torch.nnet.CNN import GaborConv1d
from speechbrain_tpu_torch.nnet.normalization import PCEN
from speechbrain_tpu_torch.nnet.pooling import GaussianLowpassPooling
from speechbrain_tpu_torch.processing.features import (
    DCT,
    STFT,
    ContextWindow,
    Deltas,
    Filterbank,
)
from speechbrain_tpu_torch.utils.autocast import fwd_default_precision


def _deltas_and_context(extractor, feats):
    """Features, then with ``extractor.deltas`` their first and second time
    derivatives concatenated on the feature axis, then with
    ``extractor.context`` each frame's neighbours (``Fbank``'s and
    ``MFCC``'s last steps)."""
    if extractor.deltas:
        delta1 = extractor.compute_deltas(feats)
        delta2 = extractor.compute_deltas(delta1)
        feats = torch.cat([feats, delta1, delta2], dim=2)
    if extractor.context:
        feats = extractor.context_window(feats)
    return feats


class Fbank:
    """Log-mel filterbank features from raw waveforms:
    STFT -> |.|^2 -> mel -> dB; with ``deltas``, the first and second
    time derivatives (``Deltas``) joined on the feature axis; with
    ``context``, each frame's ``left_frames`` and ``right_frames``
    neighbours joined after it (``ContextWindow``). Both follow the fused
    kernel (one launch a call) as they follow the unfused chain.

    Example
    -------
    >>> import torch
    >>> fbank = Fbank(device="cpu")
    >>> fbank(torch.zeros(10, 16000)).shape
    torch.Size([10, 101, 40])
    >>> Fbank(deltas=True, context=True, device="cpu")(
    ...     torch.zeros(10, 16000)).shape
    torch.Size([10, 101, 1320])
    """

    def __init__(self, deltas=False, context=False, sample_rate=16000,
                 f_min=0, f_max=None, n_fft=400, n_mels=40,
                 filter_shape="triangular", left_frames=5, right_frames=5,
                 win_length=25, hop_length=10, fused=False, device="cuda"):
        if f_max is None:
            f_max = sample_rate // 2
        self.deltas = deltas
        self.context = context
        self.fused = fused
        self.compute_deltas = Deltas(input_size=n_mels)
        self.context_window = ContextWindow(left_frames=left_frames,
                                            right_frames=right_frames)
        self.compute_STFT = STFT(
            sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
            hop_length=hop_length, device=device,
        )
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape, device=device,
        )
        # the fused path's DFT tables and the kernel's layout of them,
        # made once
        self._tables = self._operands = None
        if fused:
            self._tables = dft_tables(self.compute_STFT.window, n_fft)
            self._operands = kernel_operands(
                *self._tables, self.compute_fbanks.fbank_matrix
            )

    @fwd_default_precision
    def __call__(self, wav):
        # float32 under autocast too: the kernel takes float32 only, and
        # the plain and unfused versions then compute as it does
        if self.fused:
            fbanks = fused_fbank(
                wav,
                window=self.compute_STFT.window,
                fbank_matrix=self.compute_fbanks.fbank_matrix,
                n_fft=self.compute_STFT.n_fft,
                hop_length=self.compute_STFT.hop_length,
                top_db=self.compute_fbanks.top_db,
                tables=self._tables,
                operands=self._operands,
            )
        else:
            fbanks = self.compute_fbanks(self.compute_STFT.power(wav))
        return _deltas_and_context(self, fbanks)

    def get_filter_properties(self):
        return self.compute_STFT.get_filter_properties()


class MFCC:
    """Mel-frequency cepstral coefficients from raw waveforms: STFT ->
    |.|^2 -> mel -> dB -> ``DCT`` (``n_mfcc`` of ``n_mels``), then the
    deltas and context window as in :class:`Fbank` (both on by default).
    No kernel: the fused B3 kernel ends in log-mels.

    Example
    -------
    >>> MFCC(device="cpu")(torch.zeros(10, 16000)).shape
    torch.Size([10, 101, 660])
    """

    def __init__(self, deltas=True, context=True, sample_rate=16000,
                 f_min=0, f_max=None, n_fft=400, n_mels=23, n_mfcc=20,
                 filter_shape="triangular", left_frames=5, right_frames=5,
                 win_length=25, hop_length=10, device="cuda"):
        if f_max is None:
            f_max = sample_rate // 2
        self.deltas = deltas
        self.context = context
        self.compute_STFT = STFT(
            sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
            hop_length=hop_length, device=device,
        )
        self.compute_fbanks = Filterbank(
            sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max, filter_shape=filter_shape, device=device,
        )
        self.compute_dct = DCT(input_size=n_mels, n_out=n_mfcc, device=device)
        self.compute_deltas = Deltas(input_size=n_mfcc)
        self.context_window = ContextWindow(left_frames=left_frames,
                                            right_frames=right_frames)

    @fwd_default_precision
    def __call__(self, wav):
        fbanks = self.compute_fbanks(self.compute_STFT.power(wav))
        return _deltas_and_context(self, self.compute_dct(fbanks))


class Leaf(nn.Module):
    """LEAF, the learnable audio front end (Zeghidour et al., ICLR 2021):
    Gabor filterbank -> squared modulus -> Gaussian lowpass pooling ->
    floor at 1e-5 -> PCEN. (batch, time[, 1]) waveforms -> (batch,
    time', out_channels), one frame every ``window_stride`` ms.

    The squared modulus of filter ``c`` is ``real_c ** 2 + imag_c ** 2``
    (``GaborConv1d`` gives the real responses, then the imaginary ones).
    The JAX package pairs neighbouring channels of that output instead
    (``reshape(B, T, C, 2)``), which adds two real or two imaginary
    responses of neighbouring filters; the port does not copy it
    (ROADMAP C41).

    Example
    -------
    >>> leaf = Leaf(out_channels=8, device="cpu")
    >>> leaf(torch.ones(2, 8000)).shape
    torch.Size([2, 50, 8])
    """

    def __init__(self, out_channels=40, window_len=25.0, window_stride=10.0,
                 sample_rate=16000, min_freq=60.0, max_freq=None,
                 use_pcen=True, device="cuda", dtype=torch.float32):
        super().__init__()
        self.out_channels = out_channels
        window_size = int(sample_rate * window_len / 1000) + 1
        kw = dict(device=device, dtype=dtype)
        self.complex_conv = GaborConv1d(
            2 * out_channels, window_size, stride=1,
            sample_rate=sample_rate, min_freq=min_freq, max_freq=max_freq,
            **kw)
        self.pooling = GaussianLowpassPooling(
            out_channels, kernel_size=window_size,
            stride=int(sample_rate * window_stride / 1000), **kw)
        self.compression = PCEN(out_channels, **kw) if use_pcen else None

    def forward(self, x):
        out = self.complex_conv(x)
        C = self.out_channels
        out = out[..., :C] ** 2 + out[..., C:] ** 2
        out = self.pooling(out).clamp(min=1e-5)
        if self.compression is not None:
            out = self.compression(out)
        return out


def upalign_value(x, to):
    """``x`` rounded up to a multiple of ``to``."""
    if x % to == 0:
        return x
    return x + to - (x % to)


class StreamingFeatureWrapper:
    """Chunk-by-chunk features from a centred, strided feature extractor
    (``module``, with ``get_filter_properties()``), each frame equal to
    the offline extractor's frame over the whole stream.

    The wrapper keeps ``2 * get_required_padding()`` samples of the
    stream between chunks (``pad``, a whole number of strides: 320
    samples for ``Fbank``'s defaults) and runs ``module`` once a chunk on
    those samples and the chunk, a contiguous tensor (with
    ``Fbank(fused=True)``, one launch of the fused kernel a chunk).

    A chunk of ``n * stride`` samples yields exactly ``n`` frames, and
    over a stream every frame of the offline extractor comes out once
    and in order, ``lag = pad // stride`` frames late (2 frames, 20 ms,
    for ``Fbank``'s defaults): at stream start the first ``lag`` frames
    are centred before the stream's first sample (over zeros and the
    first samples), then offline frame ``j`` is the stream's frame
    ``j + lag``. The offline extractor's last ``lag + 1`` frames, whose
    windows reach past the stream's end, come out only if more samples
    follow (``get_recommended_final_chunk_count``). Chunk lengths must be
    whole numbers of strides.

    A per-utterance step of ``module`` sees one chunk at a time: ``Fbank``'s
    ``top_db`` floor is the loudest frame of the chunk (and its context)
    less ``top_db``, not of the whole utterance, so a frame more than
    ``top_db`` below the utterance's loudest can differ from the offline
    one.

    Example
    -------
    >>> wrapper = StreamingFeatureWrapper(Fbank(device="cpu"))
    >>> context = wrapper.make_streaming_context()
    >>> feats, context = wrapper(torch.zeros(2, 1600), context)
    >>> feats.shape
    torch.Size([2, 10, 40])
    """

    def __init__(self, module):
        self.module = module
        self.properties = module.get_filter_properties()
        if self.properties.causal:
            raise ValueError("Causal filters need no streaming wrapper")

    def get_required_padding(self):
        """Samples of context on each side of a chunk, rounded up to a
        whole number of strides."""
        return upalign_value((self.properties.window_size - 1) // 2,
                             self.properties.stride)

    def get_output_count_per_pad_frame(self):
        """The lag, in frames."""
        return self.get_required_padding() // self.properties.stride

    def get_recommended_final_chunk_count(self, frames_per_chunk):
        """Frames of zeros to feed after the stream for its last offline
        frames, rounded up to whole chunks of ``frames_per_chunk``."""
        return upalign_value(self.get_required_padding(), frames_per_chunk)

    def make_streaming_context(self, batch_size=1):
        """The state before a stream's first chunk (the batch size is
        taken from the first chunk)."""
        return {"left_context": None}

    def __call__(self, chunk, context):
        """One chunk ``(batch, samples)``; returns ``(features (batch,
        samples // stride, ...), new context)``."""
        stride = self.properties.stride
        if chunk.shape[-1] % stride:
            raise ValueError(
                f"a chunk of {chunk.shape[-1]} samples is not a whole number "
                f"of strides ({stride})"
            )
        pad = self.get_required_padding()
        left = context.get("left_context")
        if left is None:
            chunk_in = F.pad(chunk, (2 * pad, 0))
        else:
            chunk_in = torch.cat([left, chunk], dim=-1)
        new_context = {"left_context": chunk_in[:, -2 * pad:]}
        feats = self.module(chunk_in.contiguous())
        lag = pad // stride
        return feats[:, lag:lag + chunk.shape[-1] // stride], new_context

    def get_filter_properties(self):
        return self.properties
