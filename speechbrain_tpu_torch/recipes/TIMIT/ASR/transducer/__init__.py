"""TIMIT Conformer transducer (RNN-T) phoneme recognition on the PyTorch
port."""
