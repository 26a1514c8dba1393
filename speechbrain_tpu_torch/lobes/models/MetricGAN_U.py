"""MetricGAN-U (unsupervised) models (port of
``speechbrain_tpu/lobes/models/MetricGAN_U.py``): MetricGAN+'s
``EnhancementGenerator``, and a ``MetricDiscriminator`` that predicts a
non-intrusive metric from the enhanced spectrogram alone.

Submodules carry the flax scopes' names (``bn_in``, ``conv_{i}``,
``fc1``, ``fc2``, ``out``), so ``utils/jax_bridge`` loads them child by
child.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.lobes.models.MetricGAN import (  # noqa: F401
    EnhancementGenerator,
)
from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d


class MetricDiscriminator(nn.Module):
    """CNN metric predictor over ONE spectrogram, (batch, time, freq) or
    (batch, time, freq, 1): BatchNorm, four ``Conv2d`` of
    ``base_channels`` with leaky ReLU 0.3, the global mean, ``fc1`` (50),
    ``fc2`` (10), ``out`` (1), leaky ReLU 0.3 between: (batch, 1).

    Example
    -------
    >>> d = MetricDiscriminator(base_channels=4, device="cpu")
    >>> d(torch.ones(2, 10, 33)).shape
    torch.Size([2, 1])
    """

    def __init__(self, kernel_size=(5, 5), base_channels=15, in_channels=1,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.bn_in = BatchNorm1d(in_channels, **kw)
        for i in range(4):
            self.add_module(f"conv_{i}", Conv2d(
                base_channels, in_channels if i == 0 else base_channels,
                kernel_size=kernel_size, generator=generator, **kw))
        self.fc1 = Linear(50, base_channels, generator=generator, **kw)
        self.fc2 = Linear(10, 50, generator=generator, **kw)
        self.out = Linear(1, 10, generator=generator, **kw)

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]
        y = self.bn_in(x)
        for i in range(4):
            y = F.leaky_relu(getattr(self, f"conv_{i}")(y), 0.3)
        y = y.mean(dim=(1, 2))
        y = F.leaky_relu(self.fc1(y), 0.3)
        y = F.leaky_relu(self.fc2(y), 0.3)
        return self.out(y)
