"""LibriSpeech speech recognition on the PyTorch port."""
