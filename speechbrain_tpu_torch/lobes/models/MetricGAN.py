"""MetricGAN+ enhancement models (port of
``speechbrain_tpu/lobes/models/MetricGAN.py``): the BLSTM masker
``EnhancementGenerator`` with its ``LearnableSigmoid``, and the CNN
``MetricDiscriminator`` that predicts a metric of (enhanced, clean)
spectrogram pairs.

Submodules carry the flax scopes' names (``blstm``, ``linear1``,
``linear2``, ``lsigmoid``, ``bn_in``, ``conv_{i}``, ``out``), so
``utils/jax_bridge`` loads them child by child. The port's constructors
take the input widths flax infers: ``n_freq`` (``n_fft // 2 + 1``) and
``in_channels``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.RNN import LSTM


class LearnableSigmoid(nn.Module):
    """``beta * sigmoid(slope * x)``, one learnt slope a frequency
    (initialised to 1).

    Example
    -------
    >>> LearnableSigmoid(5, device="cpu")(torch.zeros(2, 5)).shape
    torch.Size([2, 5])
    """

    def __init__(self, in_features, beta=1.2, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(in_features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return self.beta * torch.sigmoid(self.slope * x)


class EnhancementGenerator(nn.Module):
    """BLSTM masker: (batch, time, n_freq) magnitudes -> a mask in
    (0, 1.2): a 2-layer bidirectional LSTM of ``lstm_neurons``,
    ``linear1`` (``dnn_neurons``), leaky ReLU 0.3, dropout in training,
    ``linear2`` (``n_freq``), ``LearnableSigmoid``.

    Example
    -------
    >>> g = EnhancementGenerator(lstm_neurons=16, dnn_neurons=16, n_freq=33,
    ...                          device="cpu")
    >>> g(torch.ones(2, 30, 33)).shape
    torch.Size([2, 30, 33])
    """

    def __init__(self, lstm_neurons=200, dnn_neurons=300, dropout=0.0,
                 n_freq=257, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        kw = dict(device=device, dtype=dtype)
        self.blstm = LSTM(hidden_size=lstm_neurons, input_size=n_freq,
                          num_layers=2, bidirectional=True, dropout=dropout,
                          generator=generator, **kw)
        self.linear1 = Linear(dnn_neurons, 2 * lstm_neurons,
                              generator=generator, **kw)
        self.linear2 = Linear(n_freq, dnn_neurons, generator=generator, **kw)
        self.lsigmoid = LearnableSigmoid(n_freq, **kw)

    def forward(self, x, lengths=None):
        y, _ = self.blstm(x)
        y = F.leaky_relu(self.linear1(y), 0.3)
        if self.training and self.dropout > 0:
            y = F.dropout(y, self.dropout, training=True)
        return self.lsigmoid(self.linear2(y))


class MetricDiscriminator(nn.Module):
    """CNN metric predictor over (batch, time, freq, 2) (enhanced, clean)
    spectrogram pairs: BatchNorm over the pair axis (statistics over
    batch, time and frequency), four ``Conv2d`` of ``base_channels`` with
    ``activation`` (leaky ReLU 0.01 by default), the global mean, then
    ``Linear`` 50 -> 10 -> 1 with the activation between: (batch, 1).

    Example
    -------
    >>> d = MetricDiscriminator(base_channels=4, device="cpu")
    >>> d(torch.ones(2, 10, 33, 2)).shape
    torch.Size([2, 1])
    """

    def __init__(self, kernel_size=(5, 5), base_channels=15,
                 activation="leaky_relu", in_channels=2, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.act = get_activation(activation)
        kw = dict(device=device, dtype=dtype)
        self.bn_in = BatchNorm1d(in_channels, **kw)
        for i in range(4):
            self.add_module(f"conv_{i}", Conv2d(
                base_channels, in_channels if i == 0 else base_channels,
                kernel_size=kernel_size, generator=generator, **kw))
        self.linear1 = Linear(50, base_channels, generator=generator, **kw)
        self.linear2 = Linear(10, 50, generator=generator, **kw)
        self.out = Linear(1, 10, generator=generator, **kw)

    def forward(self, x):
        y = self.bn_in(x)
        for i in range(4):
            y = self.act(getattr(self, f"conv_{i}")(y))
        y = y.mean(dim=(1, 2))
        y = self.act(self.linear1(y))
        y = self.act(self.linear2(y))
        return self.out(y)
