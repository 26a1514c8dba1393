"""CommonVoice speech recognition on the PyTorch port."""
