"""The BinauralWSJ0Mix separation twin."""
