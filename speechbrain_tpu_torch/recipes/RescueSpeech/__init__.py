"""The RescueSpeech twins."""
