"""The WHAM!/WHAMR! enhancement twin."""
