"""CommonVoice recipes on the PyTorch port."""
