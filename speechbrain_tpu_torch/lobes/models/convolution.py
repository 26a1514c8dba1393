"""Convolutional front-ends (port of
``speechbrain_tpu/lobes/models/convolution.py``): the strided Conv2d
subsampler placed before Conformer/Transformer ASR encoders.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d, LayerNorm


class ConvolutionFrontEnd(nn.Module):
    """Stack of strided 2D conv blocks over (batch, time, freq[, channel]).

    Output is (batch, time/prod(strides), ceil(freq/prod(strides)) *
    out_channels[-1]) after flattening the channel axis — ready for a
    Linear into d_model. ``norm`` is ``"layernorm"`` (over the channel
    axis, as in the JAX package), ``"batchnorm"`` (``BatchNorm1d`` over the
    channel axis: batch statistics in ``train()``, running ones in
    ``eval()``) or ``None``.

    Example
    -------
    >>> fe = ConvolutionFrontEnd(num_blocks=2, out_channels=(8, 16),
    ...                          strides=(2, 2), device="cpu")
    >>> fe(torch.ones(2, 64, 40)).shape
    torch.Size([2, 16, 160])
    """

    def __init__(self, num_blocks=3, num_layers_per_block=1,
                 out_channels=(128, 200, 256), kernel_sizes=(3, 3, 3),
                 strides=(2, 2, 1), dilations=(1, 1, 1),
                 residuals=(True, True, True), activation="leaky_relu",
                 norm="layernorm", dropout=0.1, in_channels=1, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        if norm not in ("layernorm", "batchnorm", None):
            raise ValueError(f"Unknown norm {norm!r}")
        # ``residuals`` is accepted and not read: the JAX module declares
        # it and adds no residual connection
        self.residuals = residuals
        self.num_blocks = num_blocks
        self.num_layers_per_block = num_layers_per_block
        self.act = get_activation(activation)
        self.dropout = dropout
        self.convs = nn.ModuleDict()
        self.norms = nn.ModuleDict()
        ch = in_channels
        for b in range(num_blocks):
            for layer in range(num_layers_per_block):
                last = layer == num_layers_per_block - 1
                stride = strides[b] if last else 1
                self.convs[f"conv_{b}_{layer}"] = Conv2d(
                    out_channels=out_channels[b],
                    in_channels=ch if layer == 0 else out_channels[b],
                    kernel_size=(kernel_sizes[b], kernel_sizes[b]),
                    stride=(stride, stride),
                    dilation=(dilations[b], dilations[b]),
                    device=device, dtype=dtype, generator=generator,
                )
            if norm == "layernorm":
                self.norms[f"norm_{b}"] = LayerNorm(
                    out_channels[b], device=device, dtype=dtype
                )
            elif norm == "batchnorm":
                self.norms[f"norm_{b}"] = BatchNorm1d(
                    out_channels[b], device=device, dtype=dtype
                )
            ch = out_channels[b]

    def forward(self, x):
        if x.ndim == 3:
            x = x[..., None]  # (B, T, F, 1)
        for b in range(self.num_blocks):
            y = x
            for layer in range(self.num_layers_per_block):
                y = self.convs[f"conv_{b}_{layer}"](y)
            if f"norm_{b}" in self.norms:
                y = self.norms[f"norm_{b}"](y)
            y = self.act(y)
            y = F.dropout(y, self.dropout, self.training)
            x = y
        B, T, Fdim, C = x.shape
        return x.reshape(B, T, Fdim * C)
