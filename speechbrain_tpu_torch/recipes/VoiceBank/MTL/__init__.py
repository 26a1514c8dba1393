"""The VoiceBank multi-task twins."""
