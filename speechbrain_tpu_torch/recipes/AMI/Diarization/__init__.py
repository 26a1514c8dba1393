"""The AMI diarization twin."""
