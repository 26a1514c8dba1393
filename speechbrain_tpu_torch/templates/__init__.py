"""Torch twins of the templates under ``templates/``."""
