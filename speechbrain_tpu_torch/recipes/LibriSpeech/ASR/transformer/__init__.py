"""The LibriSpeech Conformer CTC/attention recipe on the PyTorch port."""
