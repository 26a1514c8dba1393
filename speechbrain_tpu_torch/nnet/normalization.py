"""Normalization layers (port of ``speechbrain_tpu/nnet/normalization.py``).

Only ``LayerNorm`` is ported so far.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm(nn.Module):
    """LayerNorm over the LAST axis only, whatever the input's rank.

    The JAX package's LayerNorm wraps ``flax.linen.LayerNorm``, which
    normalises the last axis; on the 4-D ``(B, T, F, C)`` tensors of the
    convolutional front end that is the channel axis alone (upstream
    SpeechBrain normalises the last two there — the port follows the JAX
    package).

    Example
    -------
    >>> ln = LayerNorm(input_size=40, device="cpu")
    >>> ln(torch.ones(4, 10, 40)).shape
    torch.Size([4, 10, 40])
    """

    def __init__(self, input_size, eps=1e-05, elementwise_affine=True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.eps = eps
        if elementwise_affine:
            self.weight = nn.Parameter(
                torch.ones(input_size, device=device, dtype=dtype)
            )
            self.bias = nn.Parameter(
                torch.zeros(input_size, device=device, dtype=dtype)
            )
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return F.layer_norm(
            x, (self.input_size,), self.weight, self.bias, self.eps
        )
