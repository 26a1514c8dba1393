"""LibriParty voice activity detection on the PyTorch port."""
