"""Vector quantisers of self-supervised pretraining (port of
``speechbrain_tpu/nnet/quantisers.py``: ``GumbelVectorQuantizer``, wav2vec
2.0's, and ``RandomProjectionQuantizer``, BEST-RQ's).

Every random draw (the codebook's and the random projection's init, the
Gumbel noise) comes from the ``torch.Generator`` the caller passes, through
:func:`_uniform` and :func:`_normal`. As in the JAX package the Gumbel
temperature stays at ``temp_tuple[0]`` unless a caller passes ``temp``: it is
never annealed.
"""

import math

import torch
import torch.nn as nn

from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.utils.autocast import fwd_default_precision


def _uniform(shape, generator, device):
    """Uniform [0, 1) float32 draws of ``shape`` on ``device``, made on the
    generator's device (the CPU for None)."""
    gen_device = generator.device if generator is not None else "cpu"
    return torch.rand(shape, generator=generator, device=gen_device).to(device)


def _normal(shape, generator, device):
    """Standard normal float32 draws, made as :func:`_uniform`'s."""
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator,
                       device=gen_device).to(device)


class GumbelVectorQuantizer(nn.Module):
    """Gumbel-softmax vector quantisation over ``groups`` codebooks of
    ``num_vars`` entries each.

    ``forward(x, train=False, temp=None, generator=None)`` on ``(B, T,
    dim)`` returns ``{"x": (B, T, vq_dim), "prob_perplexity", "num_vars",
    "temp"}``. In training, Gumbel noise ``-log(-log(u + 1e-20) + 1e-20)``
    (``u`` from ``generator``) joins the logits, the softmax at the
    temperature picks a hard one-hot and the gradient goes through the
    soft probabilities (straight-through); in evaluation the one-hot of
    the logits' argmax. ``prob_perplexity`` is taken on the mean soft
    probabilities (no noise, no temperature) over all ``B * T`` frames,
    padded ones included, as in the JAX package. The softmax and the
    perplexity are computed in float32 under autocast.

    Example
    -------
    >>> q = GumbelVectorQuantizer(dim=16, num_vars=8, groups=2, vq_dim=8,
    ...                           device="cpu")
    >>> q(torch.ones(2, 10, 16))["x"].shape
    torch.Size([2, 10, 8])
    """

    def __init__(self, dim, num_vars=320, temp_tuple=(2.0, 0.5, 0.999995),
                 groups=2, vq_dim=256, device="cuda", generator=None):
        super().__init__()
        self.num_vars = num_vars
        self.temp_tuple = tuple(temp_tuple)
        self.groups = groups
        self.vq_dim = vq_dim
        self.weight_proj = Linear(groups * num_vars, input_size=dim,
                                  device=device, generator=generator)
        self.codebook = nn.Parameter(_uniform(
            (1, groups * num_vars, vq_dim // groups), generator, device))

    def forward(self, x, train=False, temp=None, generator=None):
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        temp = temp if temp is not None else self.temp_tuple[0]
        logits = self.weight_proj(x).float().reshape(B * T * G, V)
        if train:
            u = _uniform(logits.shape, generator, logits.device)
            g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
            probs = torch.softmax((logits + g) / temp, dim=-1)
            hard = nn.functional.one_hot(probs.argmax(-1), V).to(probs.dtype)
            assign = (hard - probs).detach() + probs
        else:
            assign = nn.functional.one_hot(logits.argmax(-1), V).float()
        avg_probs = torch.softmax(logits.reshape(B * T, G, V), -1).mean(0)
        prob_perplexity = torch.exp(
            -torch.sum(avg_probs * torch.log(avg_probs + 1e-7), dim=-1)
        ).sum()
        cb = self.codebook[0].reshape(G, V, self.vq_dim // G)
        quantized = torch.einsum("ngv,gvd->ngd",
                                 assign.reshape(B * T, G, V),
                                 cb.to(assign.dtype))
        return {
            "x": quantized.reshape(B, T, self.vq_dim),
            "prob_perplexity": prob_perplexity,
            "num_vars": V * G,
            "temp": temp,
        }


class RandomProjectionQuantizer(nn.Module):
    """BEST-RQ's quantiser: a frozen random projection ``P`` ``(input_dim,
    cb_dim)`` and a frozen random codebook ``CB`` ``(cb_vocab, cb_dim)``;
    the target of a frame is the codeword of highest cosine with its
    projection (both L2-normalised with eps 1e-12).

    ``P`` and ``CB`` are buffers: saved in the state dict, outside every
    optimizer, never trained. ``P`` is drawn as flax's
    ``variance_scaling(1, "fan_in", "uniform")``, ``CB`` as N(0, 1), from
    ``generator``. The cosines are float32 under autocast.

    Example
    -------
    >>> q = RandomProjectionQuantizer(16, cb_dim=8, cb_vocab=32, device="cpu")
    >>> q(torch.ones(2, 10, 16)).shape
    torch.Size([2, 10])
    """

    def __init__(self, input_dim, cb_dim=16, cb_vocab=8192, device="cuda",
                 generator=None):
        super().__init__()
        limit = math.sqrt(3.0 / input_dim)
        P = (2.0 * _uniform((input_dim, cb_dim), generator, device) - 1.0)
        self.register_buffer("P", P * limit)
        self.register_buffer("CB", _normal((cb_vocab, cb_dim), generator,
                                           device))

    @torch.no_grad()
    @fwd_default_precision
    def forward(self, x):
        proj = torch.matmul(x, self.P)
        proj = proj / proj.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        cb = self.CB / self.CB.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.einsum("btd,vd->btv", proj, cb).argmax(-1)
