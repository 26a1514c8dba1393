"""LibriSpeech character CTC ASR on the PyTorch port."""
