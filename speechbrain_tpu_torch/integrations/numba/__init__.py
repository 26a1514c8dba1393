"""Transducer loss (the reference keeps a Numba CUDA kernel here)."""
