"""VoiceBank-DEMAND enhancement and dereverberation on the PyTorch port."""
