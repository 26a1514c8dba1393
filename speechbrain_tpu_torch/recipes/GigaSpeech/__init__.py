"""GigaSpeech recipes on the PyTorch port."""
