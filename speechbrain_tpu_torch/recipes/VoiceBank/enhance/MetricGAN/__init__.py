"""The VoiceBank MetricGAN+ twin; its ``GanBrain``, ``run`` and ``main`` serve the other GAN twins."""
