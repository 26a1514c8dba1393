"""Data augmentation (port of ``speechbrain_tpu/augment``: so far the
``Resample`` of ``time_domain.py``)."""
