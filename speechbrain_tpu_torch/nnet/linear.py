"""Linear transformation layers (port of ``speechbrain_tpu/nnet/linear.py``).

The JAX package stores the kernel ``(in_features, out_features)`` and
infers the input width lazily; here the width is given at construction
and the weight is stored PyTorch-style ``(out_features, in_features)``
(``utils/jax_bridge.py`` transposes when carrying weights across).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(tensor, fan_in, generator=None):
    """Fill ``tensor`` in place with N(0, 1/fan_in) drawn from
    ``generator``. The numbers are drawn on the generator's device (the
    CPU for a default generator) and copied over, so one seed gives the
    same weights on every device."""
    gen_device = generator.device if generator is not None else "cpu"
    noise = torch.randn(
        tensor.shape, generator=generator, device=gen_device,
        dtype=torch.float32,
    )
    with torch.no_grad():
        tensor.copy_(noise * (1.0 / math.sqrt(max(1, fan_in))))
    return tensor


class Linear(nn.Module):
    """y = x W^T + b over the last axis; optionally flattens a trailing
    channel axis first (``combine_dims``). With ``max_norm`` each output
    unit's weight row is scaled down, in the forward, to a norm of at most
    ``max_norm`` (``min(1, max_norm / (norm + 1e-12))``); the stored weight
    is left as it is.

    Example
    -------
    >>> lin = Linear(n_neurons=100, input_size=40, device="cpu")
    >>> lin(torch.ones(8, 50, 40)).shape
    torch.Size([8, 50, 100])
    """

    def __init__(self, n_neurons, input_size, bias=True, combine_dims=False,
                 max_norm=None, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.n_neurons = n_neurons
        self.input_size = input_size
        self.combine_dims = combine_dims
        self.max_norm = max_norm
        self.weight = nn.Parameter(
            torch.empty(n_neurons, input_size, device=device, dtype=dtype)
        )
        lecun_normal_(self.weight, input_size, generator)
        self.bias = (
            nn.Parameter(torch.zeros(n_neurons, device=device, dtype=dtype))
            if bias else None
        )

    def forward(self, x):
        if x.ndim == 4 and self.combine_dims:
            x = x.reshape(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])
        weight = self.weight
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(weight, dim=1, keepdim=True)
            weight = weight * torch.clamp(self.max_norm / (norm + 1e-12),
                                          max=1.0)
        return F.linear(x, weight, self.bias)
