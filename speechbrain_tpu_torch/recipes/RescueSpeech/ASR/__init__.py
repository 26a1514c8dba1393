"""The RescueSpeech ASR twins."""
