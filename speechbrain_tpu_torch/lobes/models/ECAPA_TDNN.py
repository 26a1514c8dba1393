"""ECAPA-TDNN speaker embeddings (port of
``speechbrain_tpu/lobes/models/ECAPA_TDNN.py``): a Res2Net multi-scale
TDNN with squeeze-excitation, multi-layer feature aggregation and
attentive statistics pooling, and the cosine ``Classifier`` trained with
AAM-softmax.

Channels-last (batch, time, channel) like the JAX modules; the input
width is given at construction (flax infers it). Submodules carry the
flax scopes' names, so ``utils/jax_bridge.py`` loads the JAX trees by
name. Only the poolings mask by relative lengths (``round(lengths * T)``,
half to even); the convolutions run across padded frames with reflect
padding, so a padded utterance is not the same function as the
utterance alone, in the JAX package too.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.linear import Linear, lecun_normal_
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.pooling import length_mask


def _mask(x, lengths):
    """(B, T, 1) float32 mask of the valid frames (all where no lengths)."""
    if lengths is None:
        return torch.ones(x.shape[0], x.shape[1], 1, device=x.device)
    return length_mask(x, lengths)


class TDNNBlock(nn.Module):
    """Conv1d -> ReLU -> BatchNorm1d.

    Example
    -------
    >>> block = TDNNBlock(16, 64, kernel_size=3, device="cpu")
    >>> block(torch.ones(2, 20, 16)).shape
    torch.Size([2, 20, 64])
    """

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1,
                 groups=1, device="cuda", generator=None):
        super().__init__()
        self.conv = Conv1d(out_channels, kernel_size, in_channels,
                           dilation=dilation, groups=groups, device=device,
                           generator=generator)
        self.norm = BatchNorm1d(out_channels, device=device)

    def forward(self, x):
        return self.norm(F.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Hierarchical convolutions over ``scale`` channel splits: the first
    split passes, split i > 0 goes through ``block_i`` after adding the
    previous block's output (i > 1)."""

    def __init__(self, in_channels, out_channels, scale=8, kernel_size=3,
                 dilation=1, device="cuda", generator=None):
        super().__init__()
        assert in_channels % scale == 0 and out_channels % scale == 0
        self.scale = scale
        for i in range(1, scale):
            self.add_module(f"block_{i}", TDNNBlock(
                in_channels // scale, out_channels // scale, kernel_size,
                dilation, device=device, generator=generator))

    def forward(self, x):
        outputs, y = [], None
        for i, chunk in enumerate(torch.chunk(x, self.scale, dim=-1)):
            if i == 0:
                y = chunk
            else:
                block = getattr(self, f"block_{i}")
                y = block(chunk if i == 1 else chunk + y)
            outputs.append(y)
        return torch.cat(outputs, dim=-1)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over channels from the masked time
    average."""

    def __init__(self, in_channels, se_channels, out_channels,
                 device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv1d(se_channels, 1, in_channels, **kw)
        self.conv2 = Conv1d(out_channels, 1, se_channels, **kw)

    def forward(self, x, lengths=None):
        mask = _mask(x, lengths).to(x.dtype)
        total = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        s = (x * mask).sum(dim=1, keepdim=True) / total
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(s))))
        return x * s


class AttentiveStatisticsPooling(nn.Module):
    """Attention-weighted mean and standard deviation over time, the
    attention fed with the masked global mean and deviation beside each
    frame (``global_context``): (B, T, C) -> (B, 1, 2C).

    The padded frames' scores are -inf before the softmax over time; the
    softmax and the statistics are taken in float32 (also under
    autocast). A row of zero length has no valid frame, and its output is
    NaN, as in the JAX package."""

    def __init__(self, channels, attention_channels=128, global_context=True,
                 eps=1e-12, device="cuda", generator=None):
        super().__init__()
        self.eps = eps
        self.global_context = global_context
        kw = dict(device=device, generator=generator)
        self.tdnn = TDNNBlock(channels * (3 if global_context else 1),
                              attention_channels, 1, 1, **kw)
        self.conv = Conv1d(channels, 1, attention_channels, **kw)

    def forward(self, x, lengths=None):
        mask = _mask(x, lengths)
        xf = x.float()
        total = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        if self.global_context:
            mean = (xf * mask).sum(dim=1, keepdim=True) / total
            var = (((xf - mean) ** 2) * mask).sum(dim=1, keepdim=True) / total
            std = torch.sqrt(var.clamp(min=self.eps))
            attn_in = torch.cat([xf, mean.expand_as(xf), std.expand_as(xf)],
                                dim=-1).to(x.dtype)
        else:
            attn_in = x
        a = self.conv(torch.tanh(self.tdnn(attn_in))).float()
        a = torch.softmax(a.masked_fill(mask == 0, float("-inf")), dim=1)
        mean = (a * xf).sum(dim=1)
        var = (a * (xf - mean[:, None, :]) ** 2).sum(dim=1)
        std = torch.sqrt(var.clamp(min=self.eps))
        return torch.cat([mean, std], dim=-1)[:, None, :]


class SERes2NetBlock(nn.Module):
    """1x1 TDNN -> Res2Net -> 1x1 TDNN -> SE, plus the input (through a
    1x1 ``shortcut`` convolution where the widths differ)."""

    def __init__(self, in_channels, out_channels, res2net_scale=8,
                 se_channels=128, kernel_size=1, dilation=1, device="cuda",
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.shortcut = (Conv1d(out_channels, 1, in_channels, **kw)
                         if in_channels != out_channels else None)
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1, 1, **kw)
        self.res2net = Res2NetBlock(out_channels, out_channels, res2net_scale,
                                    kernel_size, dilation, **kw)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1, 1, **kw)
        self.se = SEBlock(out_channels, se_channels, out_channels, **kw)

    def forward(self, x, lengths=None):
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.tdnn2(self.res2net(self.tdnn1(x)))
        return self.se(y, lengths=lengths) + residual


class ECAPA_TDNN(nn.Module):
    """(batch, time, input_size) features -> (batch, 1, lin_neurons)
    embeddings.

    Example
    -------
    >>> model = ECAPA_TDNN(80, lin_neurons=192,
    ...                    channels=(64, 64, 64, 64, 192), device="cpu")
    >>> model.eval()(torch.ones(2, 120, 80)).shape
    torch.Size([2, 1, 192])
    """

    def __init__(self, input_size, lin_neurons=192,
                 channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128,
                 global_context=True, device="cuda", generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.n_blocks = len(channels) - 1
        self.block_0 = TDNNBlock(input_size, channels[0], kernel_sizes[0],
                                 dilations[0], **kw)
        for i in range(1, self.n_blocks):
            self.add_module(f"block_{i}", SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale=res2net_scale,
                se_channels=se_channels, kernel_size=kernel_sizes[i],
                dilation=dilations[i], **kw))
        self.mfa = TDNNBlock(sum(channels[1:-1]), channels[-1],
                             kernel_sizes[-1], dilations[-1], **kw)
        self.asp = AttentiveStatisticsPooling(
            channels[-1], attention_channels, global_context, **kw)
        self.asp_bn = BatchNorm1d(2 * channels[-1], device=device)
        self.fc = Conv1d(lin_neurons, 1, 2 * channels[-1], **kw)

    def forward(self, x, lengths=None):
        x = self.block_0(x)
        feats = []
        for i in range(1, self.n_blocks):
            x = getattr(self, f"block_{i}")(x, lengths=lengths)
            feats.append(x)
        x = self.mfa(torch.cat(feats, dim=-1))
        x = self.asp_bn(self.asp(x, lengths=lengths))
        return self.fc(x)


class Classifier(nn.Module):
    """Cosine similarity of the embedding with each class's weight
    column: ``lin_blocks`` Linear + BatchNorm blocks, then
    ``normalize(x) @ normalize(weight, dim=0)``; the weight is stored
    (input_size, out_neurons) as in the JAX package. (B, [1,] D) ->
    (B, out_neurons).

    Example
    -------
    >>> clf = Classifier(192, out_neurons=100, device="cpu")
    >>> clf(torch.ones(4, 1, 192)).shape
    torch.Size([4, 100])
    """

    def __init__(self, input_size, out_neurons, lin_blocks=0,
                 lin_neurons=192, device="cuda", generator=None):
        super().__init__()
        self.lin_blocks = lin_blocks
        width = input_size
        for i in range(lin_blocks):
            self.add_module(f"linear_{i}", Linear(
                lin_neurons, width, device=device, generator=generator))
            self.add_module(f"norm_{i}", BatchNorm1d(lin_neurons,
                                                     device=device))
            width = lin_neurons
        self.weight = nn.Parameter(torch.empty(width, out_neurons,
                                               device=device))
        lecun_normal_(self.weight, width, generator)

    def forward(self, x):
        for i in range(self.lin_blocks):
            x = getattr(self, f"norm_{i}")(getattr(self, f"linear_{i}")(x))
        if x.ndim == 3:
            x = x[:, 0, :]
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
            min=1e-12)
        w = self.weight / torch.linalg.vector_norm(
            self.weight, dim=0, keepdim=True).clamp(min=1e-12)
        return x @ w.to(x.dtype)
