"""The PIQ convolutional encoder (port of the encoder half of
``speechbrain_tpu/lobes/models/PIQ.py``: ``ResBlockAudio`` and
``Conv2dEncoder_v2``).

The JAX modules build flax's ``nn.Conv`` and ``nn.BatchNorm`` directly,
not the package's wrappers, so their defaults are flax's: zero padding
(``SAME`` at stride 1, an integer elsewhere), a bias on every
convolution, BatchNorm momentum 0.99 and epsilon 1e-5. The submodules
carry the flax scopes' names, the auto-named ones included (``Conv_0``,
``BatchNorm_0``, ...).
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.normalization import BatchNorm2d

# flax.linen.BatchNorm's default running-statistics decay
FLAX_BN_MOMENTUM = 0.99


def _flax_bn(dim, device):
    return BatchNorm2d(dim, momentum=FLAX_BN_MOMENTUM, device=device)


class ResBlockAudio(nn.Module):
    """x + BN(conv1x1(relu(BN(conv3x3(relu(x)))))) on (B, H, W, dim).

    Example
    -------
    >>> block = ResBlockAudio(8, device="cpu")
    >>> block.eval()(torch.ones(2, 5, 4, 8)).shape
    torch.Size([2, 5, 4, 8])
    """

    def __init__(self, dim, device="cuda", generator=None):
        super().__init__()
        self.Conv_0 = Conv2d(dim, dim, (3, 3), padding=1, device=device,
                             generator=generator)
        self.BatchNorm_0 = _flax_bn(dim, device)
        self.Conv_1 = Conv2d(dim, dim, (1, 1), padding="valid",
                             device=device, generator=generator)
        self.BatchNorm_1 = _flax_bn(dim, device)

    def forward(self, x):
        h = self.BatchNorm_0(self.Conv_0(torch.relu(x)))
        h = self.BatchNorm_1(self.Conv_1(torch.relu(h)))
        return x + h


class Conv2dEncoder_v2(nn.Module):
    """(B, T, F) log-spectrogram -> (B, T/16, F/16, dim): four 4x4
    convolutions of stride 2 and one zero of padding, each followed by
    BatchNorm and ReLU, then a ``ResBlockAudio``. With ``return_reps``
    also ``[out, stage 4, stage 3]`` for the interpretability heads.

    Example
    -------
    >>> enc = Conv2dEncoder_v2(dim=8, device="cpu")
    >>> enc.eval()(torch.ones(2, 64, 32)).shape
    torch.Size([2, 4, 2, 8])
    """

    def __init__(self, dim=256, return_reps=False, device="cuda",
                 generator=None):
        super().__init__()
        self.return_reps = return_reps
        width = 1
        for i in range(1, 5):
            self.add_module(f"conv{i}", Conv2d(
                dim, width, (4, 4), stride=(2, 2), padding=1, device=device,
                generator=generator))
            self.add_module(f"bn{i}", _flax_bn(dim, device))
            width = dim
        self.resblock = ResBlockAudio(dim, device=device, generator=generator)

    def forward(self, x):
        x = x[..., None]
        reps = []
        for i in range(1, 5):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
            reps.append(x)
        out = self.resblock(x)
        if self.return_reps:
            return out, [out, reps[-1], reps[-2]]
        return out
