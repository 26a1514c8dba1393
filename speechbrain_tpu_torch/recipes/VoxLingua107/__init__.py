"""VoxLingua107 language identification on the PyTorch port."""
