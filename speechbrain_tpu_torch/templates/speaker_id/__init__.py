"""Torch twin of ``templates/speaker_id``."""
