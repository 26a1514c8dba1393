"""ZaionEmotionDataset speech emotion diarization on the PyTorch port."""
