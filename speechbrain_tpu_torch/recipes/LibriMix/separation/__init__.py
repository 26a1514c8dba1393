"""The LibriMix separation twin."""
