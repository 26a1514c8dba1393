"""SEGAN: speech enhancement GAN on raw waveforms (port of
``speechbrain_tpu/lobes/models/segan_model.py``): the ``Generator``, a
strided convolutional autoencoder with skip connections and a latent
``z``, and the ``Discriminator`` over (noisy, enhanced or clean) pairs.

Submodules carry the flax scopes' names (``enc_{i}``, ``dec_{i}``,
``dec_out``, ``conv_{i}``, ``out``), so ``utils/jax_bridge`` loads them
child by child. Convolutions are the port's ``Conv1d`` ("same", reflected
at the edges) and ``ConvTranspose1d`` (the JAX package's padding).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.CNN import Conv1d, ConvTranspose1d
from speechbrain_tpu_torch.nnet.linear import Linear


class Generator(nn.Module):
    """Waveform autoencoder: ``len(channels)`` stride-2 convolutions
    (leaky ReLU 0.3), the latent ``z`` concatenated on the channel axis,
    stride-2 transposed convolutions (padding ``(K - 2) // 2``, leaky ReLU
    0.3) each summed with its encoder stage cut to the shorter length, a
    one-channel transposed convolution and tanh, padded or cut to the
    input's length. (batch, time) -> (batch, time), or (batch, time, 1) ->
    (batch, time, 1).

    ``forward(x, z=None, generator=None)``: ``z`` (batch, time / 2^L,
    channels[-1]) as given, or drawn from N(0, 1) with ``generator``.

    Example
    -------
    >>> g = Generator(kernel_size=32, channels=(4, 8), device="cpu")
    >>> g(torch.ones(1, 1024)).shape
    torch.Size([1, 1024])
    """

    def __init__(self, kernel_size=32, channels=(16, 32, 32, 64, 64, 128),
                 latent_noise=True, in_channels=1, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.channels = tuple(channels)
        self.latent_noise = latent_noise
        kw = dict(device=device, dtype=dtype, generator=generator)
        c_in = in_channels
        for i, ch in enumerate(self.channels):
            self.add_module(f"enc_{i}", Conv1d(ch, kernel_size, c_in,
                                               stride=2, **kw))
            c_in = ch
        if latent_noise:
            c_in *= 2
        pad = (kernel_size - 2) // 2
        for i, ch in enumerate(reversed(self.channels[:-1])):
            self.add_module(f"dec_{i}", ConvTranspose1d(
                ch, kernel_size, c_in, stride=2, padding=pad, **kw))
            c_in = ch
        self.dec_out = ConvTranspose1d(1, kernel_size, c_in, stride=2,
                                       padding=pad, **kw)

    def forward(self, x, z=None, generator=None):
        squeeze = x.ndim == 2
        y = x[..., None] if squeeze else x
        skips = []
        for i in range(len(self.channels)):
            y = F.leaky_relu(getattr(self, f"enc_{i}")(y), 0.3)
            skips.append(y)
        if self.latent_noise:
            if z is None:
                z = torch.randn(y.shape, generator=generator,
                                device=y.device, dtype=y.dtype)
            y = torch.cat([y, z.to(y.dtype)], dim=-1)
        for i in range(len(self.channels) - 1):
            y = F.leaky_relu(getattr(self, f"dec_{i}")(y), 0.3)
            skip = skips[-(i + 2)]
            T = min(y.shape[1], skip.shape[1])
            y = y[:, :T] + skip[:, :T]
        y = torch.tanh(self.dec_out(y))
        T_out = x.shape[1]
        if y.shape[1] < T_out:
            y = F.pad(y, (0, 0, 0, T_out - y.shape[1]))
        y = y[:, :T_out]
        return y[..., 0] if squeeze else y


class Discriminator(nn.Module):
    """Convolutional discriminator over (batch, time, 2) waveform pairs:
    ``len(channels)`` stride-2 convolutions (leaky ReLU 0.3), the mean
    over time, ``Linear(1)``: (batch, 1).

    Example
    -------
    >>> d = Discriminator(kernel_size=8, channels=(4, 8), device="cpu")
    >>> d(torch.ones(2, 256, 2)).shape
    torch.Size([2, 1])
    """

    def __init__(self, kernel_size=32, channels=(16, 32, 32, 64, 64, 128),
                 in_channels=2, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.channels = tuple(channels)
        kw = dict(device=device, dtype=dtype, generator=generator)
        c_in = in_channels
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv_{i}", Conv1d(ch, kernel_size, c_in,
                                                stride=2, **kw))
            c_in = ch
        self.out = Linear(1, c_in, **kw)

    def forward(self, x):
        y = x
        for i in range(len(self.channels)):
            y = F.leaky_relu(getattr(self, f"conv_{i}")(y), 0.3)
        return self.out(y.mean(dim=1))
