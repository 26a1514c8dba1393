"""Fairseq wav2vec wrappers (port of
``speechbrain_tpu/lobes/models/fairseq_wav2vec.py``). Deprecated upstream
in favour of the HuggingFace wrappers; fairseq is not bundled. Importing
this module warns; constructing either class raises ``ImportError``. Use
the native :mod:`speechbrain_tpu_torch.lobes.models.wav2vec` instead."""

import warnings

warnings.warn(
    "fairseq wav2vec wrappers are deprecated; use "
    "speechbrain_tpu_torch.lobes.models.wav2vec",
    DeprecationWarning,
    stacklevel=2,
)


class FairseqWav2Vec2:
    """Unavailable: fairseq is not installed (deprecated path)."""

    def __init__(self, *args, **kwargs):
        raise ImportError(
            "fairseq is not installed and this integration is deprecated; "
            "use the native wav2vec2 implementation."
        )


class FairseqWav2Vec1(FairseqWav2Vec2):
    """Unavailable: fairseq is not installed (deprecated path)."""
