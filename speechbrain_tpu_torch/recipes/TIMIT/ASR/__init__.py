"""TIMIT phoneme recognition on the PyTorch port."""
