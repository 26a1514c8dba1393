"""Aishell1Mix source separation on the PyTorch port."""
