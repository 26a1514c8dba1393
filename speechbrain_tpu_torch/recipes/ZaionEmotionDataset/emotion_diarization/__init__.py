"""The ZaionEmotionDataset emotion diarization twin."""
