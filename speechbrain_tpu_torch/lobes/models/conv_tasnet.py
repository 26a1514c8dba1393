"""Conv-TasNet and its binaural variants (port of
``speechbrain_tpu/lobes/models/conv_tasnet.py``): an adaptive filterbank
encoder, a temporal convolutional mask network (stacks of dilated
depthwise-separable blocks) and a linear-basis decoder with overlap-add.

Channels-last like the JAX modules; the input widths are given at
construction. Submodules carry the flax scopes' names, so
``utils/jax_bridge.py`` loads the JAX trees by name (the decoder's
``basis_signals``, a flax ``Dense``, is a ``Linear`` here).
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.lobes.models.dual_path import pad_or_trim, prelu
from speechbrain_tpu_torch.nnet.CNN import Conv1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import LayerNorm
from speechbrain_tpu_torch.processing.features import (
    STFT,
    spectral_magnitude,
)
from speechbrain_tpu_torch.processing.signal_processing import (
    overlap_and_add,
)


class ChannelwiseLayerNorm(nn.Module):
    """cLN: a LayerNorm over the channels of each frame."""

    def __init__(self, channels, device="cuda"):
        super().__init__()
        self.ln = LayerNorm(channels, device=device)

    def forward(self, x):
        return self.ln(x)


class GlobalLayerNorm(nn.Module):
    """gLN: normalised over (time, channel) jointly with the biased
    variance, eps 1e-8, then ``gamma`` and ``beta`` a channel."""

    def __init__(self, channels, eps=1e-8, device="cuda"):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        mean = x.mean((1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean((1, 2), keepdim=True)
        return self.gamma * (x - mean) * torch.rsqrt(var + self.eps) \
            + self.beta


def _choose_norm(norm_type, channels, device):
    if norm_type == "gLN":
        return GlobalLayerNorm(channels, device=device)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channels, device=device)
    raise ValueError(f"Unsupported norm {norm_type}")


class TemporalBlock(nn.Module):
    """1x1 convolution -> PReLU -> norm -> dilated depthwise convolution
    ('same', reflect padding, or causal) -> PReLU -> norm -> pointwise
    convolution, with a residual."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation,
                 norm_type="gLN", causal=False, device="cuda"):
        super().__init__()
        self.conv1x1 = Conv1d(out_channels, 1, in_channels=in_channels,
                              bias=False, device=device)
        self.prelu = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.norm1 = _choose_norm(norm_type, out_channels, device)
        self.dw = Conv1d(out_channels, kernel_size, in_channels=out_channels,
                         dilation=dilation, groups=out_channels,
                         padding="causal" if causal else "same", bias=False,
                         device=device)
        self.prelu2 = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.norm2 = _choose_norm(norm_type, out_channels, device)
        self.pointwise = Conv1d(in_channels, 1, in_channels=out_channels,
                                bias=False, device=device)

    def forward(self, x):
        y = self.norm1(prelu(self.conv1x1(x), self.prelu))
        y = self.norm2(prelu(self.dw(y), self.prelu2))
        return x + self.pointwise(y)


class MaskNet(nn.Module):
    """The temporal convolutional mask network: encoder features (B, T, N)
    -> masks (B, C, T, N). cLN, a bottleneck to B channels, R repeats of
    X blocks of H channels at dilations 1, 2, ..., 2^(X-1), PReLU, a 1x1
    convolution to C·N, and ReLU (or a softmax over the sources).

    Example
    -------
    >>> net = MaskNet(N=8, B=4, H=8, P=3, X=2, R=1, C=2, device="cpu")
    >>> net(torch.ones(2, 50, 8)).shape
    torch.Size([2, 2, 50, 8])
    """

    def __init__(self, N, B, H, P, X, R, C, norm_type="gLN", causal=False,
                 mask_nonlinear="relu", device="cuda"):
        super().__init__()
        self.N, self.C = N, C
        self.mask_nonlinear = mask_nonlinear
        self.ln_in = ChannelwiseLayerNorm(N, device=device)
        self.bottleneck = Conv1d(B, 1, in_channels=N, bias=False,
                                 device=device)
        self.blocks = []
        for r in range(R):
            for b in range(X):
                name = f"tcn_{r}_{b}"
                self.add_module(name, TemporalBlock(
                    B, H, P, 2 ** b, norm_type=norm_type, causal=causal,
                    device=device))
                self.blocks.append(name)
        self.prelu_out = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.mask_conv = Conv1d(C * N, 1, in_channels=B, bias=False,
                                device=device)

    def forward(self, x):
        Bsz, T, _ = x.shape
        y = self.bottleneck(self.ln_in(x))
        for name in self.blocks:
            y = getattr(self, name)(y)
        y = self.mask_conv(prelu(y, self.prelu_out))
        y = y.reshape(Bsz, T, self.C, self.N).transpose(1, 2)
        if self.mask_nonlinear == "softmax":
            return torch.softmax(y, dim=1)
        return F.relu(y)


class Encoder(nn.Module):
    """Waveform (B, T) -> non-negative basis coefficients (B, K, N): a
    convolution of frame ``L`` at stride ``L // 2`` and a ReLU.

    Example
    -------
    >>> enc = Encoder(L=16, N=8, device="cpu")
    >>> enc(torch.ones(2, 160)).shape
    torch.Size([2, 19, 8])
    """

    def __init__(self, L, N, device="cuda"):
        super().__init__()
        self.conv1d_U = Conv1d(N, L, in_channels=1, stride=L // 2,
                               padding="valid", bias=False, device=device)

    def forward(self, mixture):
        return F.relu(self.conv1d_U(mixture[..., None]))


class Decoder(nn.Module):
    """Masked basis coefficients -> waveforms: ``mixture_w`` (B, K, N)
    times ``est_mask`` (B, C, K, N), a linear basis to frames of ``L``
    and overlap-add at ``L // 2``; (B, T, C).

    Example
    -------
    >>> dec = Decoder(L=16, N=8, device="cpu")
    >>> dec(torch.ones(2, 19, 8), torch.ones(2, 2, 19, 8)).shape
    torch.Size([2, 160, 2])
    """

    def __init__(self, L, N, device="cuda"):
        super().__init__()
        self.L = L
        self.basis_signals = Linear(L, input_size=N, bias=False,
                                    device=device)

    def forward(self, mixture_w, est_mask):
        frames = self.basis_signals(mixture_w[:, None] * est_mask)
        Bsz, C, K, L = frames.shape
        est = overlap_and_add(frames.reshape(Bsz * C, K, L), self.L // 2)
        return est.reshape(Bsz, C, -1).transpose(1, 2)


class ConvTasNetWrapper(nn.Module):
    """Encoder + ``MaskNet`` + decoder: mixture (B, T) -> sources (B, T,
    num_spks), padded or cut to the input's length.

    Example
    -------
    >>> model = ConvTasNetWrapper(L=16, N=8, B=4, H=8, P=3, X=2, R=1,
    ...                           num_spks=2, device="cpu")
    >>> model(torch.ones(1, 800)).shape
    torch.Size([1, 800, 2])
    """

    def __init__(self, L=16, N=512, B=128, H=512, P=3, X=8, R=3, num_spks=2,
                 norm_type="gLN", causal=False, mask_nonlinear="relu",
                 device="cuda"):
        super().__init__()
        self.encoder = Encoder(L, N, device=device)
        self.masknet = MaskNet(N, B, H, P, X, R, num_spks,
                               norm_type=norm_type, causal=causal,
                               mask_nonlinear=mask_nonlinear, device=device)
        self.decoder = Decoder(L, N, device=device)

    def forward(self, mix):
        w = self.encoder(mix)
        return pad_or_trim(self.decoder(w, self.masknet(w)), mix.shape[1])


def linear_resize_weights(in_size, out_size):
    """The (in_size, out_size) float32 matrix of ``jax.image.resize``'s
    "linear" method along one axis: a triangle kernel at half-pixel
    centres, widened by in/out where it downsamples (antialiasing),
    each output's weights renormalised to sum to 1 (the edges), zero
    where the sample falls outside the input."""
    inv_scale = np.float32(in_size) / np.float32(out_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def linear_resize(x, size, dim=1):
    """``x`` resized along ``dim`` to ``size`` as ``jax.image.resize(...,
    "linear")`` does (:func:`linear_resize_weights`)."""
    w = torch.from_numpy(linear_resize_weights(x.shape[dim], size)).to(
        device=x.device, dtype=x.dtype)
    return torch.tensordot(x.movedim(dim, -1), w, dims=1).movedim(-1, dim)


class BinauralConvTasNetWrapper(nn.Module):
    """Binaural Conv-TasNet with the BinauralWSJ0Mix recipe's interaural
    schemes: stereo mixture (B, T, 2) -> estimates (B, T, 2, num_spks).

    * ``independent``: each ear its own encoder, mask network and
      decoder;
    * ``parallel``: each mask network sees both ears' encodings and
      masks both; an ear's estimate sums both networks' contributions;
    * ``cross``: the interaural level difference (the log ratio of the
      ears' STFT magnitudes, n_fft 256, hop 128), resized to the
      encoder's frames as ``jax.image.resize`` does, projected by a
      learned 1x1 convolution ``ild_proj`` and concatenated to each ear's
      encoding (negated for the right).

    Example
    -------
    >>> model = BinauralConvTasNetWrapper(L=16, N=8, B=4, H=8, P=3, X=1,
    ...     R=1, num_spks=2, mode="parallel", device="cpu")
    >>> model(torch.ones(1, 800, 2)).shape
    torch.Size([1, 800, 2, 2])
    """

    def __init__(self, L=16, N=128, B=128, H=512, P=3, X=8, R=3, num_spks=2,
                 mode="parallel", sample_rate=8000, norm_type="gLN",
                 device="cuda"):
        super().__init__()
        self.N = N
        self.mode = mode
        self.sample_rate = sample_rate
        self.encoder_l = Encoder(L, N, device=device)
        self.encoder_r = Encoder(L, N, device=device)
        self.decoder_l = Decoder(L, N, device=device)
        self.decoder_r = Decoder(L, N, device=device)
        in_N = N if mode == "independent" else 2 * N
        for ear in ("l", "r"):
            self.add_module(f"masknet_{ear}", MaskNet(
                in_N, B, H, P, X, R, num_spks, norm_type=norm_type,
                device=device))
        self.stft = None
        if mode == "cross":
            self.stft = self._make_stft(device)
            self.ild_proj = Conv1d(N, 1, in_channels=129, device=device)

    def _make_stft(self, device):
        return STFT(sample_rate=self.sample_rate,
                    win_length=256 * 1000.0 / self.sample_rate,
                    hop_length=128 * 1000.0 / self.sample_rate, n_fft=256,
                    device=device)

    def _ild(self, mix):
        """Interaural level difference (B, frames, 129) in dB."""
        if self.stft.window.device != mix.device:
            self.stft = self._make_stft(mix.device)
        eps = 1e-8
        mag_l = spectral_magnitude(self.stft(mix[..., 0]), power=0.5)
        mag_r = spectral_magnitude(self.stft(mix[..., 1]), power=0.5)
        return 10.0 * torch.log10(mag_l / (mag_r + eps) + eps)

    def forward(self, mix):
        N = self.N
        wl = self.encoder_l(mix[..., 0])
        wr = self.encoder_r(mix[..., 1])
        if self.mode == "independent":
            est_l = self.decoder_l(wl, self.masknet_l(wl))
            est_r = self.decoder_r(wr, self.masknet_r(wr))
        elif self.mode == "cross":
            ild = self.ild_proj(linear_resize(self._ild(mix), wl.shape[1]))
            ml = self.masknet_l(torch.cat([wl, ild], -1))[..., :N]
            mr = self.masknet_r(torch.cat([wr, -ild], -1))[..., :N]
            est_l = self.decoder_l(wl, ml)
            est_r = self.decoder_r(wr, mr)
        else:
            mask_l = self.masknet_l(torch.cat([wl, wr], -1))
            wl2 = self.encoder_r(mix[..., 0])
            wr2 = self.encoder_l(mix[..., 1])
            mask_r = self.masknet_r(torch.cat([wl2, wr2], -1))
            sep_l = wl[:, None] * mask_l[..., :N] \
                + wl2[:, None] * mask_r[..., :N]
            sep_r = wr[:, None] * mask_l[..., N:] \
                + wr2[:, None] * mask_r[..., N:]
            # sep_* are masked features already: decoded against a unit
            # mixture, the decoder applies the basis alone
            est_l = self.decoder_l(torch.ones_like(wl), sep_l)
            est_r = self.decoder_r(torch.ones_like(wr), sep_r)
        return pad_or_trim(torch.stack([est_l, est_r], dim=2), mix.shape[1])
