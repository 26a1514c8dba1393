"""Switchboard recipes on the PyTorch port."""
