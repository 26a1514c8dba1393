"""IEMOCAP emotion recognition on the PyTorch port."""
