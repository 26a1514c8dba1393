"""VoxCeleb recipes on the PyTorch port."""
