"""VoxPopuli data preparation on the PyTorch port (the CTC recipe itself is not
ported)."""
