"""CRDNN encoder: CNN blocks, then a recurrent stack, then DNN blocks (port
of ``speechbrain_tpu/lobes/models/CRDNN.py``), the encoder of the classic
seq2seq/CTC ASR recipes (``asr-crdnn-rnnlm-librispeech``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.CNN import Conv2d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import BatchNorm1d
from speechbrain_tpu_torch.nnet.pooling import Pooling2d
from speechbrain_tpu_torch.nnet.RNN import GRU, LSTM, LiGRU, SLiGRU

RNN_CLASSES = {"lstm": LSTM, "gru": GRU, "ligru": LiGRU, "sligru": SLiGRU}


class FeatureChannelNorm(nn.Module):
    """LayerNorm over the two trailing axes (feature, channel) of
    ``(B, T, F, C)``, with ``(F, C)`` scale and bias: flax's
    ``LayerNorm(reduction_axes=(-2, -1), feature_axes=(-2, -1))`` at its
    default eps of 1e-6, with its variance ``E[x^2] - E[x]^2`` (clipped at
    0), in float32."""

    def __init__(self, n_feats, n_channels, eps=1e-6, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.shape = (n_feats, n_channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(self.shape, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.shape, device=device,
                                             dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean((-2, -1), keepdim=True)
        var = torch.clamp((xf * xf).mean((-2, -1), keepdim=True)
                          - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class CRDNN(nn.Module):
    """``(batch, time, feat)`` -> ``(batch, time', dnn_neurons)``.

    Each CNN block is two 'same' 3x3 convolutions, each followed by the
    (feature, channel) LayerNorm and the activation, then max pooling of
    the feature axis (of both axes with ``using_2d_pooling``), then in
    training a dropout whose mask is drawn per (time, feature) position
    and shared by every channel. Then optional time pooling, the flatten
    of (feature, channel), an optional projection, the recurrent stack
    (``rnn_class``: lstm, gru, ligru or sligru, with dropout between its
    layers), and DNN blocks of Linear, BatchNorm, activation and dropout.
    ``input_size`` is the number of features; ``time'`` is ``time //
    time_pooling_size`` with ``time_pooling``.

    Example
    -------
    >>> model = CRDNN(input_size=40, cnn_channels=(8, 16), rnn_neurons=32,
    ...               dnn_neurons=32, device="cpu").eval()
    >>> model(torch.ones(2, 40, 40)).shape
    torch.Size([2, 40, 32])
    """

    def __init__(self, input_size, activation="leaky_relu", dropout=0.15,
                 cnn_blocks=2, cnn_channels=(128, 256),
                 cnn_kernelsize=(3, 3), time_pooling=False,
                 time_pooling_size=2, freq_pooling_size=2, rnn_class="lstm",
                 inter_layer_pooling_size=(2, 2), using_2d_pooling=False,
                 rnn_layers=4, rnn_neurons=512, rnn_bidirectional=True,
                 rnn_re_init=True, dnn_blocks=2, dnn_neurons=512,
                 projection_dim=-1, use_rnnp=False, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.act = get_activation(activation)
        self.dropout = dropout
        self.cnn_blocks = cnn_blocks
        self.time_pooling = time_pooling
        self.convs = nn.ModuleList()
        self.cnn_norms = nn.ModuleList()
        self.pools = nn.ModuleList()
        n_feats, in_ch = input_size, 1
        for b in range(cnn_blocks):
            ch = cnn_channels[b]
            for k in range(2):
                self.convs.append(Conv2d(
                    out_channels=ch, in_channels=in_ch if k == 0 else ch,
                    kernel_size=cnn_kernelsize, generator=generator, **kw,
                ))
                self.cnn_norms.append(FeatureChannelNorm(n_feats, ch, **kw))
            pool = inter_layer_pooling_size[b]
            if pool > 1:
                window = (pool, pool) if using_2d_pooling else (1, pool)
                self.pools.append(Pooling2d("max", window))
                n_feats //= pool
            else:
                self.pools.append(nn.Identity())
            in_ch = ch
        self.time_pool = (Pooling2d("max", (time_pooling_size, 1))
                          if time_pooling else None)
        rnn_in = n_feats * in_ch
        self.proj = None
        if projection_dim > 0:
            self.proj = Linear(projection_dim, rnn_in, generator=generator,
                               **kw)
            rnn_in = projection_dim
        self.rnn = RNN_CLASSES[rnn_class](
            hidden_size=rnn_neurons, input_size=rnn_in,
            num_layers=rnn_layers, bidirectional=rnn_bidirectional,
            dropout=dropout, generator=generator, **kw,
        )
        dnn_in = rnn_neurons * (2 if rnn_bidirectional else 1)
        self.dnn = nn.ModuleList()
        self.dnn_norms = nn.ModuleList()
        for _ in range(dnn_blocks):
            self.dnn.append(Linear(dnn_neurons, dnn_in, generator=generator,
                                   **kw))
            self.dnn_norms.append(BatchNorm1d(dnn_neurons, **kw))
            dnn_in = dnn_neurons

    def _drop(self, x, channel_shared=False):
        if not self.training or self.dropout <= 0:
            return x
        if not channel_shared:
            return F.dropout(x, self.dropout, training=True)
        keep = 1.0 - self.dropout
        u = torch.rand((*x.shape[:-1], 1), device=x.device)
        return x * ((u < keep).to(x.dtype) / keep)

    def forward(self, x, lengths=None):
        y = x[..., None] if x.ndim == 3 else x
        for b in range(self.cnn_blocks):
            for k in range(2):
                y = self.convs[2 * b + k](y)
                y = self.act(self.cnn_norms[2 * b + k](y))
            y = self.pools[b](y)
            y = self._drop(y, channel_shared=True)
        if self.time_pool is not None:
            y = self.time_pool(y)
        B, T, Fd, C = y.shape
        y = y.reshape(B, T, Fd * C)
        if self.proj is not None:
            y = self.proj(y)
        y, _ = self.rnn(y)
        for lin, norm in zip(self.dnn, self.dnn_norms):
            y = self._drop(self.act(norm(lin(y))))
        return y
