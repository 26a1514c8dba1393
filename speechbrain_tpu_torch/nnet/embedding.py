"""Embedding layer (port of ``speechbrain_tpu/nnet/embedding.py``)."""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Embedding(nn.Module):
    """Lookup embeddings (batch, time) int -> (batch, time, dim),
    initialised N(0, 1) like the JAX package's table.

    Example
    -------
    >>> emb = Embedding(num_embeddings=10, embedding_dim=4, device="cpu")
    >>> emb(torch.tensor([[1, 2, 3]])).shape
    torch.Size([1, 3, 4])
    """

    def __init__(self, num_embeddings, embedding_dim=128, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        gen_device = generator.device if generator is not None else "cpu"
        table = torch.randn(
            num_embeddings, embedding_dim, generator=generator,
            device=gen_device, dtype=torch.float32,
        )
        self.weight = nn.Parameter(table.to(device=device, dtype=dtype))

    def forward(self, x):
        return F.embedding(x.long(), self.weight)
