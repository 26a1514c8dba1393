"""Activation functions (port of ``speechbrain_tpu/nnet/activations.py``):
``Softmax`` with length masking, ``GumbelSoftmax``, ``Swish`` and the
functions the model families use.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet import quantisers


class Softmax(nn.Module):
    """Softmax, or log-softmax with ``apply_log``, over ``axis``; given
    relative ``lengths``, the frames of axis 1 past ``round(length * T)``
    get zero probability. ``reshape`` is accepted for the JAX package's
    signature.

    Example
    -------
    >>> Softmax(apply_log=True)(torch.ones(2, 3)).shape
    torch.Size([2, 3])
    """

    def __init__(self, apply_log=False, axis=-1, reshape=True):
        super().__init__()
        self.apply_log = apply_log
        self.axis = axis

    def forward(self, x, lengths=None):
        if lengths is not None:
            T = x.shape[1]
            mask = (torch.arange(T, device=x.device)[None, :]
                    < torch.round(lengths * T)[:, None])
            x = x.masked_fill(
                ~mask.reshape(mask.shape + (1,) * (x.ndim - 2)),
                float("-inf"))
        if self.apply_log:
            return torch.log_softmax(x, dim=self.axis)
        return torch.softmax(x, dim=self.axis)


class GumbelSoftmax(nn.Module):
    """Gumbel-softmax sampling over the last axis: ``softmax((x + g) /
    tau)`` with Gumbel noise ``g = -log(-log(u + 1e-20) + 1e-20)``, ``u``
    uniform from ``generator`` (drawn through the quantisers' draw
    helper); with ``hard`` the one-hot of its argmax forward and the soft
    sample's gradient backward; with ``apply_log`` ``log(y + 1e-20)``.

    Example
    -------
    >>> gs = GumbelSoftmax(hard=True)
    >>> y = gs(torch.zeros(2, 5), generator=torch.Generator().manual_seed(0))
    >>> y.sum(-1).tolist()
    [1.0, 1.0]
    """

    def __init__(self, tau=1.0, hard=False, apply_log=False):
        super().__init__()
        self.tau = tau
        self.hard = hard
        self.apply_log = apply_log

    def forward(self, x, generator=None):
        u = quantisers._uniform(x.shape, generator, x.device)
        gumbels = -torch.log(-torch.log(u + 1e-20) + 1e-20)
        y = torch.softmax((x + gumbels) / self.tau, dim=-1)
        if self.hard:
            y_hard = F.one_hot(y.argmax(-1), x.shape[-1]).to(y.dtype)
            y = (y_hard - y).detach() + y
        if self.apply_log:
            return torch.log(y + 1e-20)
        return y


def swish(x, beta=1.0):
    """x * sigmoid(beta x) (SiLU when beta=1).

    Example
    -------
    >>> float(swish(torch.tensor(0.0)))
    0.0
    """
    return x * torch.sigmoid(beta * x)


class Swish(nn.Module):
    """The :func:`swish` activation as a module."""

    def __init__(self, beta=1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return swish(x, self.beta)


def relu(x):
    return F.relu(x)


def leaky_relu(x, negative_slope=0.01):
    return F.leaky_relu(x, negative_slope)


def gelu(x):
    """GELU in its tanh approximation — the default of ``jax.nn.gelu``,
    which the JAX package uses (PyTorch's own default is the erf form)."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "relu": relu,
    "leaky_relu": leaky_relu,
    "gelu": gelu,
    "swish": swish,
    "sigmoid": torch.sigmoid,
}


def get_activation(name_or_fn):
    """Resolve an activation by name or pass through a callable."""
    if callable(name_or_fn):
        return name_or_fn
    return ACTIVATIONS[name_or_fn]
