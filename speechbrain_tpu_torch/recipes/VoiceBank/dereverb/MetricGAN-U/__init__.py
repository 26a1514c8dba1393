"""The VoiceBank MetricGAN-U dereverberation twin."""
