"""Classic speech-enhancement baselines (port of
``speechbrain_tpu/lobes/models/MaskingSE.py``): the waveform-mapping FCN
and three spectral maskers, a (batch, time, freq) magnitude spectrogram
in and a (batch, time, freq) sigmoid mask out.

Submodules carry the flax scopes' names (``in0``, ``conv{i}``, ``bn{i}``,
``head``, ``blstm``, ``lin1``, ``lin2``, ``freq_proj``, ``bottleneck``),
so ``utils/jax_bridge`` loads them child by child. Convolutions are the
port's ``Conv1d``/``Conv2d`` with the JAX package's "same" padding
(reflected at the edges), recurrences the port's cuDNN ``LSTM``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.CNN import Conv1d, Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import (
    BatchNorm2d,
    InstanceNorm1d,
)
from speechbrain_tpu_torch.nnet.RNN import LSTM


class WaveFCNMapper(nn.Module):
    """Fully-convolutional waveform-to-waveform enhancement (Fu 2018):
    an affine instance norm of the wave, ``num_blocks`` stages of
    convolution, affine instance norm and leaky ReLU (slope 0.3), then a
    one-channel convolution. (batch, time) -> (batch, time), or (batch,
    time, 1) -> (batch, time, 1).

    Example
    -------
    >>> net = WaveFCNMapper(base_channels=4, num_blocks=2, kernel_size=7,
    ...                     device="cpu")
    >>> net(torch.ones(2, 64)).shape
    torch.Size([2, 64])
    """

    def __init__(self, base_channels=80, num_blocks=8, kernel_size=55,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_blocks = num_blocks
        self.in0 = InstanceNorm1d(1, affine=True, **kw)
        for i in range(1, num_blocks + 1):
            self.add_module(f"conv{i}", Conv1d(
                base_channels, kernel_size, 1 if i == 1 else base_channels,
                generator=generator, **kw))
            self.add_module(f"in{i}", InstanceNorm1d(base_channels,
                                                     affine=True, **kw))
        self.head = Conv1d(1, kernel_size, base_channels,
                           generator=generator, **kw)

    def forward(self, x):
        squeeze = x.ndim == 2
        h = self.in0(x[..., None] if squeeze else x)
        for i in range(1, self.num_blocks + 1):
            h = getattr(self, f"conv{i}")(h)
            h = F.leaky_relu(getattr(self, f"in{i}")(h), 0.3)
        h = self.head(h)
        return h[..., 0] if squeeze else h


class _MaskHead(nn.Module):
    """The BLSTM -> ``lin1`` -> leaky ReLU -> ``lin2`` -> sigmoid tail of
    the recurrent maskers."""

    def _build_head(self, n_freq, hidden_size, num_layers, lin_size, kw,
                    generator):
        self.blstm = LSTM(hidden_size, n_freq, num_layers=num_layers,
                          bidirectional=True, generator=generator, **kw)
        self.lin1 = Linear(lin_size, 2 * hidden_size, generator=generator,
                           **kw)
        self.lin2 = Linear(n_freq, lin_size, generator=generator, **kw)

    def _head(self, x):
        out, _ = self.blstm(x)
        out = F.leaky_relu(self.lin1(out), 0.01)
        return torch.sigmoid(self.lin2(out))


class BLSTMMasker(_MaskHead):
    """BLSTM mask estimator (Fu 2020): a bidirectional LSTM, ``lin1``,
    leaky ReLU (0.01), ``lin2``, sigmoid.

    Example
    -------
    >>> net = BLSTMMasker(n_freq=33, hidden_size=8, lin_size=12,
    ...                   device="cpu")
    >>> net(torch.ones(2, 10, 33)).shape
    torch.Size([2, 10, 33])
    """

    def __init__(self, n_freq=257, hidden_size=200, num_layers=2,
                 lin_size=300, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self._build_head(n_freq, hidden_size, num_layers, lin_size,
                         dict(device=device, dtype=dtype), generator)

    def forward(self, x):
        return self._head(x)


def _fcn_stack(module, num_blocks, base_channels, kernel_size, kw,
               generator):
    """``conv{i}`` (2-D, "same") and ``bn{i}`` of the FCN maskers."""
    for i in range(1, num_blocks + 1):
        module.add_module(f"conv{i}", Conv2d(
            base_channels, 1 if i == 1 else base_channels,
            kernel_size=kernel_size, generator=generator, **kw))
        module.add_module(f"bn{i}", BatchNorm2d(base_channels, **kw))


def _run_fcn_stack(module, num_blocks, x):
    """(B, T, F) -> the stack's (B, T, F * C) maps, flattened frequency
    first (index ``f * C + c``, flax's row-major reshape of (B, T, F, C))."""
    h = x[..., None]
    for i in range(1, num_blocks + 1):
        h = getattr(module, f"bn{i}")(getattr(module, f"conv{i}")(h))
        h = F.leaky_relu(h, 0.01)
    return h.reshape(h.shape[0], h.shape[1], -1)


class FCN2DMasker(nn.Module):
    """2-D FCN mask estimator (Fu 2020): ``num_blocks`` stages of
    convolution over the (time, freq) plane, BatchNorm and leaky ReLU
    (0.01), then ``freq_proj``, a projection of every channel of every
    frequency to ``n_freq`` (a "valid" convolution spanning the frequency
    axis), and a sigmoid.

    Example
    -------
    >>> net = FCN2DMasker(n_freq=17, base_channels=4, num_blocks=2,
    ...                   device="cpu")
    >>> net(torch.ones(2, 6, 17)).shape
    torch.Size([2, 6, 17])
    """

    def __init__(self, n_freq=257, base_channels=64, num_blocks=7,
                 kernel_size=(9, 9), device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_blocks = num_blocks
        _fcn_stack(self, num_blocks, base_channels, kernel_size, kw,
                   generator)
        self.freq_proj = Linear(n_freq, n_freq * base_channels,
                                generator=generator, **kw)

    def forward(self, x):
        h = _run_fcn_stack(self, self.num_blocks, x)
        return torch.sigmoid(self.freq_proj(h))


class FCN2DBLSTMMasker(_MaskHead):
    """The FCN's convolution stack, ``bottleneck`` to ``n_freq``, then the
    BLSTM masker's tail.

    Example
    -------
    >>> net = FCN2DBLSTMMasker(n_freq=17, base_channels=4, num_blocks=2,
    ...                        hidden_size=8, lin_size=12, device="cpu")
    >>> net(torch.ones(2, 6, 17)).shape
    torch.Size([2, 6, 17])
    """

    def __init__(self, n_freq=257, base_channels=64, num_blocks=4,
                 kernel_size=(9, 9), hidden_size=200, num_layers=2,
                 lin_size=300, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_blocks = num_blocks
        _fcn_stack(self, num_blocks, base_channels, kernel_size, kw,
                   generator)
        self.bottleneck = Linear(n_freq, n_freq * base_channels,
                                 generator=generator, **kw)
        self._build_head(n_freq, hidden_size, num_layers, lin_size, kw,
                         generator)

    def forward(self, x):
        h = self.bottleneck(_run_fcn_stack(self, self.num_blocks, x))
        return self._head(h)
