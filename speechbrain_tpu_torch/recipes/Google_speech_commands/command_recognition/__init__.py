"""Keyword classification (x-vector, ECAPA-TDNN, x-vector over LEAF) on
the PyTorch port."""
