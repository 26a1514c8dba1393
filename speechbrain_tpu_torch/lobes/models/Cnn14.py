"""CNN14 audio tagging encoder (port of
``speechbrain_tpu/lobes/models/Cnn14.py``: ``ConvBlock`` and ``Cnn14``).

Channels-last like the JAX modules. Submodules carry the flax scopes'
names (``block_{b}`` with ``conv1``, ``bn1``, ``conv2``, ``bn2``; ``fc``),
so that ``jax_bridge`` loads them child by child.
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm2d
from speechbrain_tpu_torch.nnet.pooling import Pooling2d


class ConvBlock(nn.Module):
    """Two bias-free 3x3 convolutions ("same", reflect padding), each
    followed by BatchNorm over the channels and ReLU:
    (B, T, F, in_channels) -> (B, T, F, out_channels)."""

    def __init__(self, in_channels, out_channels, device="cuda",
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(out_channels, in_channels, (3, 3), bias=False,
                            device=device, generator=generator)
        self.bn1 = BatchNorm2d(out_channels, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, (3, 3), bias=False,
                            device=device, generator=generator)
        self.bn2 = BatchNorm2d(out_channels, device=device)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class Cnn14(nn.Module):
    """(B, T, mel_bins) features -> (B, T', emb_dim) embeddings: six
    ``ConvBlock``s of ``min(base_channels * 2**b, emb_dim)`` channels, an
    average 2x2 pooling after each of the first five, the mean over the
    frequency axis, then ``relu(fc(.))``. With ``return_reps`` also the
    maps after blocks 3, 4 and 5 (coarsest first, channels-last) for the
    interpretability heads. ``norm_type`` is taken and not read, as in
    the JAX package: the blocks always use BatchNorm.

    Example
    -------
    >>> net = Cnn14(mel_bins=24, emb_dim=32, base_channels=4, device="cpu")
    >>> net.eval()(torch.ones(2, 64, 24)).shape
    torch.Size([2, 2, 32])
    """

    def __init__(self, mel_bins=80, emb_dim=2048, norm_type="bn",
                 base_channels=64, return_reps=False, device="cuda",
                 generator=None):
        super().__init__()
        self.mel_bins = mel_bins
        self.return_reps = return_reps
        width, ch = 1, base_channels
        for b in range(6):
            out = min(ch, emb_dim)
            self.add_module(f"block_{b}", ConvBlock(width, out, device=device,
                                                    generator=generator))
            width, ch = out, ch * 2
        self.pool = Pooling2d("avg", (2, 2))
        self.fc = Linear(emb_dim, width, device=device, generator=generator)

    def forward(self, x):
        y = x[..., None]
        reps = []
        for b in range(6):
            y = getattr(self, f"block_{b}")(y)
            if b < 5:
                y = self.pool(y)
            if b >= 3:
                reps.append(y)
        emb = torch.relu(self.fc(y.mean(dim=2)))
        if self.return_reps:
            return emb, reps[::-1]
        return emb
