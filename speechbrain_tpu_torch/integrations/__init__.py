"""Integrations (port of ``speechbrain_tpu/integrations``): so far
``numba``, where the transducer loss is found under the reference's name,
and ``alignment``, where diarization is."""
