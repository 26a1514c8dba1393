"""Recipes on the PyTorch port: twins of the JAX package's ``recipes/``."""
