"""ResNet speaker embeddings (port of
``speechbrain_tpu/lobes/models/ResNet.py``): pre-activation three-
convolution blocks (BN -> ReLU -> 3x3, BN -> ReLU -> 3x3, BN -> ReLU ->
1x1) with channel squeeze-excitation on the first two stages only, stage
strides (1, 2, 2, 2), attentive statistics over time of the
frequency-flattened maps, and a BatchNorm-normalised embedding.

Maps are (batch, time, feature, channel), as in the JAX package. Each
3x3 convolution is an explicit zero padding of one then a "valid"
convolution; ``BatchNorm1d`` normalises the channels of the 4-D maps. The
flattened feature index is ``c * F' + f`` (the JAX package transposes to
(B, T', C, F') before flattening), which is the order ``attn_in``'s
weights assume. ``lengths`` are accepted and unread, as in JAX.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d


def _pad1(x):
    """Zero padding of one on time and feature of a (B, T, F, C) map."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _conv(in_channels, out_channels, k, stride, kw):
    return Conv2d(out_channels, in_channels, (k, k), stride=(stride, stride),
                  padding="valid", bias=False, **kw)


class SEBlock2d(nn.Module):
    """Channel squeeze-excitation of a (B, T, F, C) map: the mean over
    time and feature through ``fc1`` -> ReLU -> ``fc2`` -> sigmoid scales
    each channel."""

    def __init__(self, channels, reduction=1, device="cuda", generator=None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        kw = dict(device=device, generator=generator)
        self.fc1 = Linear(hidden, channels, **kw)
        self.fc2 = Linear(channels, hidden, **kw)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2))))))
        return x * s[:, None, None, :]


class PreActBlock(nn.Module):
    """Pre-activation three-convolution residual block, optionally with
    squeeze-excitation; the residual is a strided 1x1 convolution and
    BatchNorm where the stride or the width changes. No activation after
    the sum."""

    def __init__(self, in_channels, out_channels, stride=1, use_se=True,
                 device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.bn1 = BatchNorm1d(in_channels, device=device)
        self.conv1 = _conv(in_channels, out_channels, 3, stride, kw)
        self.bn2 = BatchNorm1d(out_channels, device=device)
        self.conv2 = _conv(out_channels, out_channels, 3, 1, kw)
        self.bn3 = BatchNorm1d(out_channels, device=device)
        self.conv3 = _conv(out_channels, out_channels, 1, 1, kw)
        self.se = SEBlock2d(out_channels, **kw) if use_se else None
        self.down = self.bn_down = None
        if stride != 1 or in_channels != out_channels:
            self.down = _conv(in_channels, out_channels, 1, stride, kw)
            self.bn_down = BatchNorm1d(out_channels, device=device)

    def forward(self, x):
        y = self.conv1(_pad1(F.relu(self.bn1(x))))
        y = self.conv2(_pad1(F.relu(self.bn2(y))))
        y = self.conv3(F.relu(self.bn3(y)))
        if self.se is not None:
            y = self.se(y)
        residual = x if self.down is None else self.bn_down(self.down(x))
        return y + residual


class ResNet(nn.Module):
    """(batch, time, input_size) features -> (batch, 1, lin_neurons).

    Example
    -------
    >>> net = ResNet(24, channels=(8, 8, 16, 16), layers=(1, 1, 1, 1),
    ...              lin_neurons=16, device="cpu")
    >>> net.eval()(torch.ones(2, 40, 24)).shape
    torch.Size([2, 1, 16])
    """

    def __init__(self, input_size, layers=(3, 4, 6, 3),
                 channels=(128, 128, 256, 256), lin_neurons=256,
                 attention_channels=128, strides=(1, 2, 2, 2),
                 device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv_in = _conv(1, channels[0], 3, 1, kw)
        self.bn_in = BatchNorm1d(channels[0], device=device)
        self.block_names = []
        width, freq = channels[0], input_size
        for stage, (n_blocks, planes, stride) in enumerate(
                zip(layers, channels, strides)):
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                name = f"block_{stage}_{b}"
                self.add_module(name, PreActBlock(
                    width, planes, stride=s, use_se=stage < 2, **kw))
                self.block_names.append(name)
                width = planes
                freq = (freq - 1) // s + 1  # pad 1, 3x3, stride s
        flat = width * freq
        self.attn_in = Linear(attention_channels, flat, **kw)
        self.attn_bn = BatchNorm1d(attention_channels, device=device)
        self.attn_out = Linear(flat, attention_channels, **kw)
        self.norm_stats = BatchNorm1d(2 * flat, device=device)
        self.fc_embed = Linear(lin_neurons, 2 * flat, **kw)
        self.norm_embed = BatchNorm1d(lin_neurons, device=device)

    def forward(self, x, lengths=None):
        y = F.relu(self.bn_in(self.conv_in(_pad1(x[..., None]))))
        for name in self.block_names:
            y = getattr(self, name)(y)
        B, T, Fr, C = y.shape
        feat = y.permute(0, 1, 3, 2).reshape(B, T, C * Fr)
        w = self.attn_out(self.attn_bn(F.relu(self.attn_in(feat))))
        w = torch.softmax(w.float(), dim=1)
        feat = feat.float()
        mu = (feat * w).sum(dim=1)
        sg = torch.sqrt(((feat**2) * w).sum(dim=1).sub(mu**2)
                        .clamp(min=1e-5))
        stats = self.norm_stats(torch.cat([mu, sg], dim=-1))
        return self.norm_embed(self.fc_embed(stats))[:, None, :]
