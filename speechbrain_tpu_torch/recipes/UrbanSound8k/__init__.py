"""UrbanSound8k sound classification on the PyTorch port."""
