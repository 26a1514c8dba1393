"""Deprecated alias: diarization moved to
``integrations.alignment.diarization`` (as in the reference's
``processing/diarization.py``)."""

import warnings

from speechbrain_tpu_torch.integrations.alignment.diarization import *  # noqa: F401,F403,E501

warnings.warn(
    "speechbrain_tpu_torch.processing.diarization has moved to "
    "speechbrain_tpu_torch.integrations.alignment.diarization",
    DeprecationWarning,
    stacklevel=2,
)
