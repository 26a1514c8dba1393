"""The RescueSpeech noise-robust ASR twin."""
