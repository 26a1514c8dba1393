"""The VoiceBank ASR-enhancement twin: perceptual pre-training, mimic loss, robust ASR."""
