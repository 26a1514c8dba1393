"""Composed feature extractors (port of ``speechbrain_tpu/lobes/features.py``:
``Fbank``). With ``fused=True`` the whole chain runs as one hand-written
CUDA kernel (``speechbrain_tpu_torch.ops.mel_frontend``).
"""

from speechbrain_tpu_torch.ops.mel_frontend import (
    dft_tables,
    fused_fbank,
    kernel_operands,
)
from speechbrain_tpu_torch.processing.features import STFT, Filterbank
from speechbrain_tpu_torch.utils.autocast import fwd_default_precision


class Fbank:
    """Log-mel filterbank features from raw waveforms:
    STFT -> |.|^2 -> mel -> dB.

    ``deltas`` and ``context`` are accepted for the JAX package's
    signature; neither is ported yet, and asking for one raises.

    Example
    -------
    >>> import torch
    >>> fbank = Fbank(device="cpu")
    >>> fbank(torch.zeros(10, 16000)).shape
    torch.Size([10, 101, 40])
    """

    def __init__(self, deltas=False, context=False, sample_rate=16000,
                 f_min=0, f_max=None, n_fft=400, n_mels=40,
                 filter_shape="triangular", left_frames=5, right_frames=5,
                 win_length=25, hop_length=10, fused=False, device="cuda"):
        if deltas or context:
            raise NotImplementedError(
                "Fbank(deltas=..., context=...) is not ported yet"
            )
        if f_max is None:
            f_max = sample_rate // 2
        self.fused = fused
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
            return fused_fbank(
                wav,
                window=self.compute_STFT.window,
                fbank_matrix=self.compute_fbanks.fbank_matrix,
                n_fft=self.compute_STFT.n_fft,
                hop_length=self.compute_STFT.hop_length,
                top_db=self.compute_fbanks.top_db,
                tables=self._tables,
                operands=self._operands,
            )
        mag = self.compute_STFT.power(wav)
        return self.compute_fbanks(mag)
