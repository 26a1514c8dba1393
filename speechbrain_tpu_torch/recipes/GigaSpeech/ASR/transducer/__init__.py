"""GigaSpeech Conformer transducer (RNN-T) ASR on the PyTorch port."""
