"""wav2vec 2.0 pretraining parts (port of
``speechbrain_tpu/lobes/models/wav2vec.py``): the convolutional latent
extractor, the Gumbel target quantiser, span masking, negative sampling and
the contrastive loss.

Every random draw comes from the ``torch.Generator`` the caller passes,
through :func:`_randint` (span starts, negatives' frames) and
:func:`_normal` (the noise :func:`fill_masked` puts on masked frames, as the
JAX recipes do inline). As in the JAX
package the samplers and the extractor's normalisation do not read lengths:
spans and negatives may fall on padded frames, and the waveform's mean and
variance are taken over its padded length.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import LayerNorm
from speechbrain_tpu_torch.nnet.quantisers import GumbelVectorQuantizer


def _randint(high, shape, generator, device):
    """Integers uniform in ``[0, high)`` of ``shape`` on ``device``, drawn
    on the generator's device (the CPU for None)."""
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randint(0, high, shape, generator=generator,
                         device=gen_device).to(device)


def _normal(shape, generator, device):
    """Standard normal float32 draws of ``shape`` on ``device``, drawn on
    the generator's device."""
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator,
                       device=gen_device).to(device)


class W2VLatentExtractor(nn.Module):
    """Strided convolutions from the waveform ``(B, samples)`` to latents
    ``(B, frames, out_channels[-1])``: per-utterance normalisation (mean
    and population variance over the time axis, eps 1e-5), then per layer
    a bias-free ``valid`` convolution, a LayerNorm (eps 1e-5) and the
    exact-erf GELU, and a final LayerNorm with flax's eps, 1e-6.

    The submodules carry the flax scopes' names (``conv_{i}``,
    ``norm_{i}``, ``norm``).

    Example
    -------
    >>> ext = W2VLatentExtractor(out_channels=(8, 8, 8),
    ...                          kernel_sizes=(11, 3, 3), strides=(5, 2, 2),
    ...                          device="cpu")
    >>> ext(torch.ones(2, 4000)).shape
    torch.Size([2, 198, 8])
    """

    def __init__(self, out_channels=(512,) * 7,
                 kernel_sizes=(11, 3, 3, 3, 3, 3, 3),
                 strides=(5, 2, 2, 2, 2, 2, 2), device="cuda",
                 generator=None):
        super().__init__()
        self.n_layers = len(out_channels)
        in_channels = 1
        for i, (c, k, s) in enumerate(zip(out_channels, kernel_sizes,
                                          strides)):
            self.add_module(f"conv_{i}", Conv1d(
                c, k, in_channels=in_channels, stride=s, padding="valid",
                bias=False, device=device, generator=generator))
            self.add_module(f"norm_{i}", LayerNorm(c, device=device))
            in_channels = c
        self.norm = LayerNorm(in_channels, eps=1e-6, device=device)

    def forward(self, x, normalize_signal=True):
        if normalize_signal:
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, keepdim=True, correction=0)
            x = (x - mean) / torch.sqrt(var + 1e-5)
        y = x[..., None]
        for i in range(self.n_layers):
            y = getattr(self, f"conv_{i}")(y)
            y = F.gelu(getattr(self, f"norm_{i}")(y))
        return self.norm(y)


class W2VTargetQuantiser(nn.Module):
    """The Gumbel quantiser (``quantiser``) and a projection of its
    codewords (``proj``): ``forward(x, train=False, generator=None)``
    returns ``(targets (B, T, out_dim), the quantiser's dict)``.

    Example
    -------
    >>> q = W2VTargetQuantiser(in_dim=16, out_dim=8, quantiser_vars=4,
    ...                        device="cpu")
    >>> q(torch.ones(2, 5, 16))[0].shape
    torch.Size([2, 5, 8])
    """

    def __init__(self, in_dim=512, out_dim=256, quantiser_vars=320,
                 quantiser_groups=2, device="cuda", generator=None):
        super().__init__()
        self.quantiser = GumbelVectorQuantizer(
            dim=in_dim, num_vars=quantiser_vars, groups=quantiser_groups,
            vq_dim=out_dim, device=device, generator=generator)
        self.proj = Linear(out_dim, input_size=out_dim, device=device,
                           generator=generator)

    def forward(self, x, train=False, generator=None):
        out = self.quantiser(x, train=train, generator=generator)
        return self.proj(out["x"]), out


def w2v_mask(shape, mask_prob, mask_length, generator=None, device="cuda"):
    """Span masks ``(B, T)`` bool: ``max(1, int(mask_prob * T /
    mask_length))`` span starts an utterance, each uniform in ``[0, max(T -
    mask_length, 1))``, each span ``mask_length`` frames.

    Example
    -------
    >>> m = w2v_mask((2, 50), 0.2, 5, torch.Generator().manual_seed(0),
    ...              device="cpu")
    >>> m.shape, bool(m.any(1).all())
    (torch.Size([2, 50]), True)
    """
    B, T = shape
    n_starts = max(1, int(mask_prob * T / mask_length))
    starts = _randint(max(T - mask_length, 1), (B, n_starts), generator,
                      device)
    pos = torch.arange(T, device=device)[None, None, :]
    spans = (pos >= starts[..., None]) & (pos < (starts + mask_length)[
        ..., None])
    return spans.any(dim=1)


def fill_masked(x, mask, generator=None):
    """``x`` ``(B, T, C)`` with the frames of ``mask`` ``(B, T)`` replaced
    by N(0, 0.1^2) noise, as the JAX SSL recipes fill them.

    Example
    -------
    >>> x = torch.ones(1, 3, 2)
    >>> y = fill_masked(x, torch.tensor([[False, True, False]]))
    >>> bool((y[:, [0, 2]] == 1).all() and (y[:, 1] != 1).all())
    True
    """
    noise = 0.1 * _normal(x.shape, generator, x.device)
    return torch.where(mask[..., None], noise.to(x.dtype), x)


def sample_negatives(y, num_neg, generator=None):
    """``num_neg`` negatives a frame from other frames of the same
    utterance: ``y`` ``(B, T, C)`` -> ``(num_neg, B, T, C)``. A frame's
    negative is drawn uniform over the ``T - 1`` others.

    Example
    -------
    >>> y = torch.arange(4.0).reshape(1, 4, 1)
    >>> n = sample_negatives(y, 3, torch.Generator().manual_seed(0))
    >>> n.shape, bool((n[..., 0] != y[..., 0]).all())
    (torch.Size([3, 1, 4, 1]), True)
    """
    B, T, _ = y.shape
    idx = _randint(T - 1, (num_neg, B, T), generator, y.device)
    self_idx = torch.arange(T, device=y.device)[None, None, :]
    idx = torch.where(idx >= self_idx, idx + 1, idx) % T
    return y[torch.arange(B, device=y.device)[None, :, None], idx]


def w2v_contrastive_loss(predictions, targets, negatives, mask,
                         temperature=0.1):
    """InfoNCE over the masked frames: the cosine (denominator at least
    1e-8) of each prediction with its target and with its negatives, over
    ``temperature``, the target's negative log-softmax averaged over the
    frames of ``mask`` (at least one). Computed in float32.

    Example
    -------
    >>> p = torch.ones(1, 3, 4)
    >>> mask = torch.tensor([[True, False, True]])
    >>> round(w2v_contrastive_loss(p, p, p[None].repeat(2, 1, 1, 1),
    ...                            mask).item(), 4)
    1.0986
    """
    predictions = predictions.float()

    def cos(a, b):
        a, b = torch.broadcast_tensors(a, b.float())
        den = a.norm(dim=-1) * b.norm(dim=-1)
        return (a * b).sum(-1) / den.clamp_min(1e-8)

    pos_sim = cos(predictions, targets)[None]
    neg_sim = cos(predictions[None], negatives)
    logits = torch.cat([pos_sim, neg_sim], dim=0) / temperature
    loss = -torch.log_softmax(logits, dim=0)[0]
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)
