"""The VoiceBank spectral-mask enhancement twin."""
