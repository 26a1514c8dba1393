"""Dropout variants (port of ``speechbrain_tpu/nnet/dropout.py``)."""

import torch
import torch.nn as nn


class Dropout2d(nn.Module):
    """Channel dropout on ``(batch, time, channel, ...)``: one keep-mask
    draw per (batch, channel, ...) position, shared by every time step
    (the mask is broadcast over axis 1), kept values scaled by
    ``1 / (1 - drop_rate)``. The identity in evaluation mode or at rate 0.

    ``generator`` (on the input's device) draws the masks; without one the
    device's default generator does.

    Example
    -------
    >>> drop = Dropout2d(drop_rate=0.5).eval()
    >>> x = torch.ones(4, 10, 8)
    >>> bool((drop(x) == x).all())
    True
    """

    def __init__(self, drop_rate=0.0, generator=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.generator = generator

    def mask_shape(self, x):
        return (x.shape[0], 1, *x.shape[2:])

    def forward(self, x):
        if not self.training or self.drop_rate == 0.0:
            return x
        keep = 1.0 - self.drop_rate
        u = torch.rand(self.mask_shape(x), generator=self.generator,
                       device=x.device)
        return x * ((u < keep).to(x.dtype) / keep)
