"""The VoiceBank SEGAN twin."""
