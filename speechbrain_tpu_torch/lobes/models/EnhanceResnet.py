"""ResNet spectral-mask enhancement model (port of
``speechbrain_tpu/lobes/models/EnhanceResnet.py``): pre-activation
squeeze-excitation blocks over the (time, freq) plane, a 1x1 projection to
one channel, and a sigmoid mask through a frequency projection.

Submodules carry the flax scopes' names (``block_{s}_{b}``, ``proj``,
``mask``). ``dropout`` is taken and not read, as in the JAX package.
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.ResNet import PreActBlock
from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear


class EnhanceResnet(nn.Module):
    """(batch, time, n_freq) magnitudes -> (batch, time, n_freq) mask in
    (0, 1).

    Example
    -------
    >>> net = EnhanceResnet(16, channels=(4, 8), blocks_per_stage=1,
    ...                     device="cpu")
    >>> net.eval()(torch.ones(2, 20, 16)).shape
    torch.Size([2, 20, 16])
    """

    def __init__(self, n_freq, channels=(16, 32, 64), blocks_per_stage=2,
                 dropout=0.1, device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.block_names = []
        width = 1
        for s, ch in enumerate(channels):
            for b in range(blocks_per_stage):
                name = f"block_{s}_{b}"
                self.add_module(name, PreActBlock(width, ch, use_se=True,
                                                  **kw))
                self.block_names.append(name)
                width = ch
        self.proj = Conv2d(1, width, (1, 1), **kw)
        self.mask = Linear(n_freq, n_freq, **kw)

    def forward(self, x):
        y = x[..., None]
        for name in self.block_names:
            y = getattr(self, name)(y)
        y = self.proj(y)[..., 0]
        return torch.sigmoid(self.mask(y))
