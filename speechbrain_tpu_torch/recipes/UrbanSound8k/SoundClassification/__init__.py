"""The UrbanSound8k classification twin."""
