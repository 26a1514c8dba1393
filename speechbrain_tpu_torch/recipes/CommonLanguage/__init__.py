"""CommonLanguage language identification on the PyTorch port."""
