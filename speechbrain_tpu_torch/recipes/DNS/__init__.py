"""DNS noise suppression on the PyTorch port."""
