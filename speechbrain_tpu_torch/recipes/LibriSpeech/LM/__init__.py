"""LibriSpeech language models on the PyTorch port."""
