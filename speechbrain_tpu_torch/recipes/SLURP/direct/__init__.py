"""The SLURP direct twin."""
