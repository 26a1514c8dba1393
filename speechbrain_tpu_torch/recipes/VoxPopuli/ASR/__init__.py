"""VoxPopuli speech recognition on the PyTorch port."""
