"""LibriSpeech CRDNN attention seq2seq ASR on the PyTorch port."""
