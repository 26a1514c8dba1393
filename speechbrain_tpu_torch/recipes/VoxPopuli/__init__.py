"""VoxPopuli recipes on the PyTorch port."""
