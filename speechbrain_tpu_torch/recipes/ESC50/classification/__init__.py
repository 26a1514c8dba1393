"""The ESC50 classification twin."""
