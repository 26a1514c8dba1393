"""The WSJ0Mix separation twin."""
