"""ESC50 sound classification on the PyTorch port."""
