"""AMI speaker diarization on the PyTorch port."""
