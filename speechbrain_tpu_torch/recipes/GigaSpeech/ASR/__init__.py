"""GigaSpeech speech recognition on the PyTorch port."""
