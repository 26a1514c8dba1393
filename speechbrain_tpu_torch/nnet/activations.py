"""Activation functions (port of ``speechbrain_tpu/nnet/activations.py``).

Only the functions the transformer and enhancement families use are
ported so far.
"""

import torch
import torch.nn.functional as F


def swish(x, beta=1.0):
    """x * sigmoid(beta x) (SiLU when beta=1).

    Example
    -------
    >>> float(swish(torch.tensor(0.0)))
    0.0
    """
    return x * torch.sigmoid(beta * x)


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
