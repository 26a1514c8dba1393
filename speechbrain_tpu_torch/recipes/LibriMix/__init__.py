"""LibriMix source separation on the PyTorch port."""
