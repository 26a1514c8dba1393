"""LibriSpeech recipes on the PyTorch port."""
