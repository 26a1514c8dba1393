"""Alignment (port of ``speechbrain_tpu/alignment``): so far the spectral
clustering of speaker diarization."""
