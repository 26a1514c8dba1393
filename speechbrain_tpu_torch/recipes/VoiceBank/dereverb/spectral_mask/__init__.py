"""The VoiceBank spectral-mask dereverberation twin."""
