"""X-vector speaker embeddings (port of
``speechbrain_tpu/lobes/models/Xvector.py``): a TDNN stack with
dilations, statistics pooling and an embedding layer; the MLP
``Classifier`` with log-softmax output, and the binary ``Discriminator``.

Channels-last like the JAX modules; input widths are given at
construction (flax infers them). Submodules carry the flax scopes' names
(``tdnn_i``, ``bn_i``, ``embedding``; ``norm_in``, ``linear_i``,
``norm_i``, ``out``).
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.pooling import StatisticsPooling


class Xvector(nn.Module):
    """(batch, time, in_channels) -> (batch, 1, lin_neurons).

    Example
    -------
    >>> model = Xvector(in_channels=40, device="cpu")
    >>> model.eval()(torch.ones(2, 120, 40)).shape
    torch.Size([2, 1, 512])
    """

    def __init__(self, in_channels=40, activation="leaky_relu",
                 tdnn_blocks=5, tdnn_channels=(512, 512, 512, 512, 1500),
                 tdnn_kernel_sizes=(5, 3, 3, 1, 1),
                 tdnn_dilations=(1, 2, 3, 1, 1), lin_neurons=512,
                 device="cuda", generator=None):
        super().__init__()
        self.act = get_activation(activation)
        self.tdnn_blocks = tdnn_blocks
        width = in_channels
        for i in range(tdnn_blocks):
            self.add_module(f"tdnn_{i}", Conv1d(
                tdnn_channels[i], tdnn_kernel_sizes[i], width,
                dilation=tdnn_dilations[i], device=device,
                generator=generator))
            self.add_module(f"bn_{i}", BatchNorm1d(tdnn_channels[i],
                                                   device=device))
            width = tdnn_channels[i]
        self.stats_pool = StatisticsPooling()
        self.embedding = Linear(lin_neurons, 2 * width, device=device,
                                generator=generator)

    def forward(self, x, lengths=None):
        for i in range(self.tdnn_blocks):
            x = getattr(self, f"bn_{i}")(self.act(getattr(self,
                                                          f"tdnn_{i}")(x)))
        return self.embedding(self.stats_pool(x, lengths=lengths))


class Classifier(nn.Module):
    """MLP over x-vectors: activation, BatchNorm, ``lin_blocks`` Linear +
    activation + BatchNorm blocks, then log-softmax over ``out_neurons``.

    Example
    -------
    >>> clf = Classifier(512, out_neurons=10, device="cpu")
    >>> clf.eval()(torch.ones(4, 1, 512)).shape
    torch.Size([4, 1, 10])
    """

    def __init__(self, input_size, out_neurons, activation="leaky_relu",
                 lin_blocks=1, lin_neurons=512, device="cuda",
                 generator=None):
        super().__init__()
        self.act = get_activation(activation)
        self.lin_blocks = lin_blocks
        self.norm_in = BatchNorm1d(input_size, device=device)
        width = input_size
        for i in range(lin_blocks):
            self.add_module(f"linear_{i}", Linear(
                lin_neurons, width, device=device, generator=generator))
            self.add_module(f"norm_{i}", BatchNorm1d(lin_neurons,
                                                     device=device))
            width = lin_neurons
        self.out = Linear(out_neurons, width, device=device,
                          generator=generator)

    def forward(self, x):
        x = self.norm_in(self.act(x))
        for i in range(self.lin_blocks):
            x = getattr(self, f"norm_{i}")(
                self.act(getattr(self, f"linear_{i}")(x)))
        return torch.log_softmax(self.out(x).float(), dim=-1)


class Discriminator(nn.Module):
    """Binary discriminator over embeddings: ``lin_blocks`` Linear +
    BatchNorm + activation blocks, then one logit.

    Example
    -------
    >>> disc = Discriminator(512, device="cpu")
    >>> disc.eval()(torch.ones(4, 512)).shape
    torch.Size([4, 1])
    """

    def __init__(self, input_size, activation="leaky_relu", lin_blocks=1,
                 lin_neurons=512, device="cuda", generator=None):
        super().__init__()
        self.act = get_activation(activation)
        self.lin_blocks = lin_blocks
        width = input_size
        for i in range(lin_blocks):
            self.add_module(f"linear_{i}", Linear(
                lin_neurons, width, device=device, generator=generator))
            self.add_module(f"norm_{i}", BatchNorm1d(lin_neurons,
                                                     device=device))
            width = lin_neurons
        self.out = Linear(1, width, device=device, generator=generator)

    def forward(self, x):
        for i in range(self.lin_blocks):
            x = self.act(getattr(self, f"norm_{i}")(
                getattr(self, f"linear_{i}")(x)))
        return self.out(x)
