"""The WHAM!/WHAMR! separation twin."""
