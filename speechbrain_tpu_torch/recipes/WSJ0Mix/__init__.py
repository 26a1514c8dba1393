"""WSJ0-2mix source separation on the PyTorch port."""
