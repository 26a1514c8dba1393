"""SLURP spoken language understanding on the PyTorch port."""
