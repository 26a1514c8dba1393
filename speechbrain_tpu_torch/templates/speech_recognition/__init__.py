"""Torch twin of ``templates/speech_recognition``."""
