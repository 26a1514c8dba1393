"""Spectral-clustering diarization under the reference's name
(``speechbrain/integrations/alignment/diarization.py``): re-exports
:mod:`speechbrain_tpu_torch.alignment.diarization`."""

from speechbrain_tpu_torch.alignment.diarization import *  # noqa: F401,F403
from speechbrain_tpu_torch.alignment.diarization import (  # noqa: F401
    do_spec_clustering,
    estimate_num_speakers,
    get_affinity,
    merge_ssegs_same_speaker,
    p_pruning,
    spectral_embedding,
    write_rttm,
)
