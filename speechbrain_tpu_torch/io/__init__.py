"""Native IO: the C++ WAV decoder of the data-loading hot path."""

from speechbrain_tpu_torch.io.native import (  # noqa: F401
    read_wav,
    read_wav_mono,
    wav_info,
)
