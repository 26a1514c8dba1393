"""The VoiceBank enhancement twins, and the synthetic corpus they share."""
