"""Embedding layer (port of ``speechbrain_tpu/nnet/embedding.py``)."""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Embedding(nn.Module):
    """Lookup embeddings (batch, time) int -> (batch, time, dim),
    initialised N(0, 1) like the JAX package's table.

    With ``consider_as_one_hot`` there is no weight: an id becomes its
    one-hot vector over ``num_embeddings`` without the ``blank_id``
    column, ``(batch, time, num_embeddings - 1)`` (``embedding_dim`` is
    not read).

    Example
    -------
    >>> emb = Embedding(num_embeddings=10, embedding_dim=4, device="cpu")
    >>> emb(torch.tensor([[1, 2, 3]])).shape
    torch.Size([1, 3, 4])
    >>> Embedding(4, consider_as_one_hot=True, device="cpu")(
    ...     torch.tensor([[0, 2]])).tolist()
    [[[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]
    """

    def __init__(self, num_embeddings, embedding_dim=128,
                 consider_as_one_hot=False, blank_id=0, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.consider_as_one_hot = consider_as_one_hot
        if consider_as_one_hot:
            keep = [i for i in range(num_embeddings) if i != blank_id]
            self.weight = None
            # a constant: kept out of the state dict and checkpoints
            self.register_buffer("one_hot", torch.eye(
                num_embeddings, device=device, dtype=dtype)[:, keep],
                persistent=False)
            return
        gen_device = generator.device if generator is not None else "cpu"
        table = torch.randn(
            num_embeddings, embedding_dim, generator=generator,
            device=gen_device, dtype=torch.float32,
        )
        self.weight = nn.Parameter(table.to(device=device, dtype=dtype))

    def forward(self, x):
        if self.consider_as_one_hot:
            return F.embedding(x.long(), self.one_hot)
        return F.embedding(x.long(), self.weight)
