"""The VoiceBank MetricGAN+ twin with a band-correlation target."""
