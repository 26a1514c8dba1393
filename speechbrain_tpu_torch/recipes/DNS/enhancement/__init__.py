"""The DNS SepFormer enhancement twin."""
