"""VoxCeleb speaker embeddings (ECAPA-TDNN, x-vector, ResNet) and their
verification on the PyTorch port."""
