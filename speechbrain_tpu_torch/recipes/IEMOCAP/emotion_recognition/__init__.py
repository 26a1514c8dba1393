"""The IEMOCAP emotion recognition twin."""
