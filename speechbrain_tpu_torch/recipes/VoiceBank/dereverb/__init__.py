"""The VoiceBank dereverberation twins."""
