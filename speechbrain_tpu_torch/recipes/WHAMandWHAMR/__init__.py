"""WHAM! and WHAMR! source separation on the PyTorch port."""
