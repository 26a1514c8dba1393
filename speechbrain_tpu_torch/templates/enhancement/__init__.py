"""The speech-enhancement template on the PyTorch port."""
