"""The VoiceBank waveform-mapping enhancement twin."""
