"""TIMIT recipes on the PyTorch port."""
