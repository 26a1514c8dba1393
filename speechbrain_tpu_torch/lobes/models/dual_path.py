"""Dual-path separation models, SepFormer and DPRNN (port of
``speechbrain_tpu/lobes/models/dual_path.py``): a free filterbank
encoder, a mask network that cuts the encoded mixture into 50 %-overlapping
chunks and alternates intra-chunk and inter-chunk blocks over them, one
mask a source, and a transposed-convolution decoder.

Channels-last like the JAX modules, ``(batch, time, channel)``; the input
widths are given at construction. Submodules carry the flax scopes' names,
so ``utils/jax_bridge.py`` loads the JAX trees by name. Each dual stage
holds its own copy of the intra and inter blocks (``copy.deepcopy``, the
upstream recipe's way: own weights, drawn once and copied); the JAX
package's clones draw each stage's anew.
"""

import copy
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.lobes.models.transformer.Conformer import (
    ConformerEncoder,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    PositionalEncoding,
    TransformerEncoder,
)
from speechbrain_tpu_torch.nnet.attention import RelPosEncXL
from speechbrain_tpu_torch.nnet.CNN import Conv1d, ConvTranspose1d
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import GroupNorm
from speechbrain_tpu_torch.nnet.RNN import LSTM


def prelu(x, alpha):
    """``x`` where non-negative, else ``alpha * x``."""
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def pad_or_trim(est, length):
    """``est`` (B, T', ...) cut or zero-padded along time to ``length``."""
    if est.shape[1] > length:
        return est[:, :length]
    if est.shape[1] < length:
        pad = [0, 0] * (est.ndim - 2) + [0, length - est.shape[1]]
        return F.pad(est, pad)
    return est


class Encoder(nn.Module):
    """Waveform (B, T) -> latent filterbank (B, T', N): a strided
    convolution (stride ``kernel_size // 2``, no padding, no bias) and a
    ReLU.

    Example
    -------
    >>> enc = Encoder(kernel_size=4, out_channels=8, device="cpu")
    >>> enc(torch.ones(2, 1000)).shape
    torch.Size([2, 499, 8])
    """

    def __init__(self, kernel_size=2, out_channels=64, in_channels=1,
                 device="cuda"):
        super().__init__()
        self.conv = Conv1d(out_channels, kernel_size, in_channels=in_channels,
                           stride=kernel_size // 2, padding="valid",
                           bias=False, device=device)

    def forward(self, x):
        if x.ndim == 2:
            x = x[..., None]
        return F.relu(self.conv(x))


class Decoder(nn.Module):
    """Latent (B, T', N) -> waveform (B, T) by a transposed convolution of
    stride ``kernel_size // 2`` with no bias (a trailing axis where
    ``out_channels`` > 1).

    Example
    -------
    >>> dec = Decoder(kernel_size=4, in_channels=8, device="cpu")
    >>> dec(torch.ones(2, 499, 8)).shape
    torch.Size([2, 1000])
    """

    def __init__(self, kernel_size=2, out_channels=1, in_channels=64,
                 device="cuda"):
        super().__init__()
        self.out_channels = out_channels
        self.deconv = ConvTranspose1d(out_channels, kernel_size,
                                      in_channels=in_channels,
                                      stride=kernel_size // 2, bias=False,
                                      device=device)

    def forward(self, x):
        y = self.deconv(x)
        return y[..., 0] if self.out_channels == 1 else y


class SBTransformerBlock(nn.Module):
    """The intra- or inter-chunk Transformer: the sinusoidal encoding
    added to the input, then a ``TransformerEncoder`` (pre-norm by
    default, a final LayerNorm)."""

    def __init__(self, num_layers, d_model, nhead, d_ffn=2048, dropout=0.0,
                 use_positional_encoding=True, norm_before=True,
                 attention_type="regularMHA", device="cuda"):
        super().__init__()
        self.pos = (PositionalEncoding(d_model, max_len=5000, device=device)
                    if use_positional_encoding else None)
        self.enc = TransformerEncoder(
            num_layers=num_layers, nhead=nhead, d_ffn=d_ffn, d_model=d_model,
            dropout=dropout, normalize_before=norm_before,
            attention_type=attention_type, device=device)

    def forward(self, x):
        if self.pos is not None:
            x = x + self.pos(x)
        return self.enc(x)[0]


def draw_biases_(module):
    """Every bias of ``module``'s ``Linear`` and ``Conv1d`` layers drawn
    from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch.nn's default, in place
    of the zeros of flax's (the numbers drawn on the CPU from the default
    generator, so that one seed gives the same biases on every device)."""
    for sub in module.modules():
        if isinstance(sub, (Linear, Conv1d)) and sub.bias is not None:
            bound = 1.0 / math.sqrt(sub.weight[0].numel())
            draw = torch.rand(sub.bias.shape)
            with torch.no_grad():
                sub.bias.copy_((2 * draw - 1) * bound)


class SBConformerEncoderBlock(nn.Module):
    """The Conformer intra-chunk block of
    ``sepformer-conformerintra.yaml``: relative positions
    (``RelPosEncXL``) into a ``ConformerEncoder`` with ``RelPosMHAXL``.

    Its biases start non-zero (:func:`draw_biases_`, ROADMAP C46): an
    all-padding chunk has no positional encoding added here, so with
    zero biases it stays exactly zero through every layer, and each
    LayerNorm's backward over a zero row scales the gradient by
    1/sqrt(1e-5); eight layers overflow float32 on the first step."""

    def __init__(self, num_layers, d_model, nhead, d_ffn=2048, dropout=0.0,
                 kernel_size=31, use_positional_encoding=True, device="cuda"):
        super().__init__()
        self.relpos = RelPosEncXL(d_model)
        self.enc = ConformerEncoder(
            num_layers=num_layers, d_model=d_model, d_ffn=d_ffn, nhead=nhead,
            kernel_size=kernel_size, dropout=dropout, device=device)
        draw_biases_(self.enc)

    def forward(self, x):
        return self.enc(x, pos_embs=self.relpos(x))[0]


class SBRNNBlock(nn.Module):
    """DPRNN's block: a bidirectional LSTM and a linear projection back
    to ``out_channels``."""

    def __init__(self, hidden_channels, out_channels, input_size,
                 num_layers=1, bidirectional=True, dropout=0.0,
                 device="cuda"):
        super().__init__()
        self.rnn = LSTM(hidden_size=hidden_channels, input_size=input_size,
                        num_layers=num_layers, bidirectional=bidirectional,
                        dropout=dropout, device=device)
        dirs = 2 if bidirectional else 1
        self.proj = Linear(out_channels, input_size=hidden_channels * dirs,
                           device=device)

    def forward(self, x):
        return self.proj(self.rnn(x)[0])


class DualComputationBlock(nn.Module):
    """One dual-path stage over (B, K, S, N), K the chunk length and S the
    number of chunks: the intra block over each chunk (sequences of K, a
    batch of B·S), its global layer norm (``GroupNorm`` of one group,
    eps 1e-8, over (K, S, N)) and the skip around it; then the inter block
    across chunks (sequences of S, a batch of B·K), its norm, and the sum
    with the intra branch."""

    def __init__(self, intra_mdl, inter_mdl, out_channels, norm="ln",
                 skip_around_intra=True, linear_layer_after_inter_intra=False,
                 device="cuda"):
        super().__init__()
        self.intra_mdl = intra_mdl
        self.inter_mdl = inter_mdl
        self.skip_around_intra = skip_around_intra
        self.intra_proj = self.inter_proj = None
        if linear_layer_after_inter_intra:
            self.intra_proj = Linear(out_channels, input_size=out_channels,
                                     device=device)
            self.inter_proj = Linear(out_channels, input_size=out_channels,
                                     device=device)
        self.intra_norm = self.inter_norm = None
        if norm == "ln":
            self.intra_norm = GroupNorm(out_channels, num_groups=1, eps=1e-8,
                                        device=device)
            self.inter_norm = GroupNorm(out_channels, num_groups=1, eps=1e-8,
                                        device=device)

    def forward(self, x):
        B, K, S, N = x.shape
        intra = x.transpose(1, 2).reshape(B * S, K, N)
        intra = self.intra_mdl(intra)
        if self.intra_proj is not None:
            intra = self.intra_proj(intra)
        intra = intra.reshape(B, S, K, N).transpose(1, 2)
        if self.intra_norm is not None:
            intra = self.intra_norm(intra)
        if self.skip_around_intra:
            intra = intra + x
        inter = self.inter_mdl(intra.reshape(B * K, S, N))
        if self.inter_proj is not None:
            inter = self.inter_proj(inter)
        inter = inter.reshape(B, K, S, N)
        if self.inter_norm is not None:
            inter = self.inter_norm(inter)
        return inter + intra


def segment(x, K):
    """(B, T, N) -> ((B, K, S, N) chunks of K frames at hops of K/2,
    gap): the input padded by K/2 in front and K/2 + gap behind, where
    ``gap = K - (K/2 + T % K) % K`` (1 to K) makes the padded length a
    whole number of hops."""
    if K % 2:
        raise ValueError(f"chunk size K must be even for 50%-overlap "
                         f"segmentation, got {K}")
    P = K // 2
    gap = K - (P + x.shape[1] % K) % K
    x = F.pad(x, (0, 0, P, P + gap))
    return x.unfold(1, K, P).permute(0, 3, 1, 2), gap


def overlap_add(x, gap):
    """The inverse of :func:`segment`: (B, K, S, N) -> (B, T, N). Each
    chunk's first half lands on hop s and its second on hop s + 1, so the
    output is the sum of two streams, every chunk's first halves and every
    chunk's second halves one hop later; then the padding is cut off."""
    B, K, S, N = x.shape
    P = K // 2
    halves = x.transpose(1, 2)
    first = halves[:, :, :P].reshape(B, S * P, N)
    second = halves[:, :, P:].reshape(B, S * P, N)
    out = F.pad(first, (0, 0, 0, P)) + F.pad(second, (0, 0, P, 0))
    return out[:, P:out.shape[1] - (P + gap)]


class DualPathModel(nn.Module):
    """The dual-path mask network: encoded mixture (B, T, N) -> masks
    (n_spks, B, T, N). Global layer norm, a 1x1 convolution, chunking,
    ``num_layers`` dual stages, PReLU, a 1x1 convolution to ``num_spks``
    streams, overlap-add, the tanh·sigmoid gated output, a 1x1
    convolution and a ReLU."""

    def __init__(self, in_channels, out_channels, intra_model, inter_model,
                 num_layers=1, norm="ln", K=200, num_spks=2,
                 skip_around_intra=True, linear_layer_after_inter_intra=False,
                 use_global_pos_enc=False, max_length=20000, device="cuda"):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.K = K
        self.num_spks = num_spks
        self.num_layers = num_layers
        self.norm = GroupNorm(in_channels, num_groups=1, eps=1e-8,
                              device=device)
        self.conv1x1 = Conv1d(out_channels, 1, in_channels=in_channels,
                              bias=False, device=device)
        self.pos = (PositionalEncoding(out_channels, max_len=max_length,
                                       device=device)
                    if use_global_pos_enc else None)
        for i in range(num_layers):
            self.add_module(f"dual_{i}", DualComputationBlock(
                copy.deepcopy(intra_model), copy.deepcopy(inter_model),
                out_channels, norm=norm, skip_around_intra=skip_around_intra,
                linear_layer_after_inter_intra=linear_layer_after_inter_intra,
                device=device))
        self.prelu1 = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.conv_expand = Conv1d(out_channels * num_spks, 1,
                                  in_channels=out_channels, device=device)
        self.output_gate_a = Conv1d(out_channels, 1, in_channels=out_channels,
                                    device=device)
        self.output_gate_b = Conv1d(out_channels, 1, in_channels=out_channels,
                                    device=device)
        self.end_conv1x1 = Conv1d(in_channels, 1, in_channels=out_channels,
                                  device=device)

    def forward(self, x):
        x = self.conv1x1(self.norm(x))
        if self.pos is not None:
            x = x * math.sqrt(self.out_channels) + self.pos(x)
        segs, gap = segment(x, self.K)
        for i in range(self.num_layers):
            segs = getattr(self, f"dual_{i}")(segs)
        B, K, S, N = segs.shape
        segs = prelu(segs, self.prelu1)
        segs = self.conv_expand(segs.reshape(B, K * S, N))
        segs = segs.reshape(B, K, S, self.num_spks, N).permute(3, 0, 1, 2, 4)
        est = overlap_add(segs.reshape(self.num_spks * B, K, S, N), gap)
        est = (torch.tanh(self.output_gate_a(est))
               * torch.sigmoid(self.output_gate_b(est)))
        est = F.relu(self.end_conv1x1(est))
        return est.reshape(self.num_spks, B, est.shape[1], self.in_channels)


def apply_masks(encoder, masknet, decoder, mix):
    """encoder -> masknet -> each source's masked latent through the
    decoder, stacked (B, T', n_spks) and padded or cut to the mixture's
    length: the three-module separation of the recipes and of
    ``SepformerSeparation``. ``masknet`` gives (n_spks, B, T', N)."""
    mix_w = encoder(mix)
    est_mask = masknet(mix_w)
    sep_h = mix_w[None] * est_mask
    est = torch.stack([decoder(sep_h[s]) for s in range(sep_h.shape[0])],
                      dim=-1)
    return pad_or_trim(est, mix.shape[1])


class SepformerWrapper(nn.Module):
    """Encoder + dual-path mask network + decoder: mixture (B, T) ->
    sources (B, T, n_spks). ``block_type`` "transformer" is the SepFormer,
    "rnn" DPRNN (``SBRNNBlock`` of ``rnn_hidden`` both ways), and
    "conformer_intra" a Conformer intra block with a Transformer inter
    block.

    Example
    -------
    >>> model = SepformerWrapper(
    ...     encoder_kernel_size=16, encoder_out_nchannels=32,
    ...     masknet_chunksize=20, masknet_numlayers=1, masknet_numspks=2,
    ...     intra_numlayers=1, inter_numlayers=1, intra_nhead=4,
    ...     inter_nhead=4, intra_dffn=64, inter_dffn=64, device="cpu")
    >>> model(torch.ones(1, 2000)).shape
    torch.Size([1, 2000, 2])
    """

    def __init__(self, encoder_kernel_size=16, encoder_in_nchannels=1,
                 encoder_out_nchannels=256, masknet_chunksize=250,
                 masknet_numlayers=2, masknet_norm="ln",
                 masknet_useextralinearlayer=False,
                 masknet_extraskipconnection=True, masknet_numspks=2,
                 intra_numlayers=8, inter_numlayers=8, intra_nhead=8,
                 inter_nhead=8, intra_dffn=1024, inter_dffn=1024,
                 intra_use_positional=True, inter_use_positional=True,
                 intra_norm_before=True, inter_norm_before=True,
                 block_type="transformer", rnn_hidden=128,
                 conformer_kernel_size=31, device="cuda"):
        super().__init__()
        N = encoder_out_nchannels
        self.encoder = Encoder(kernel_size=encoder_kernel_size,
                               out_channels=N, device=device)
        if block_type == "rnn":
            intra = SBRNNBlock(rnn_hidden, N, input_size=N,
                               num_layers=intra_numlayers, device=device)
            inter = SBRNNBlock(rnn_hidden, N, input_size=N,
                               num_layers=inter_numlayers, device=device)
        else:
            inter = SBTransformerBlock(
                num_layers=inter_numlayers, d_model=N, nhead=inter_nhead,
                d_ffn=inter_dffn, use_positional_encoding=inter_use_positional,
                norm_before=inter_norm_before, device=device)
        if block_type == "conformer_intra":
            intra = SBConformerEncoderBlock(
                num_layers=intra_numlayers, d_model=N, nhead=intra_nhead,
                d_ffn=intra_dffn, kernel_size=conformer_kernel_size,
                device=device)
        elif block_type != "rnn":
            intra = SBTransformerBlock(
                num_layers=intra_numlayers, d_model=N, nhead=intra_nhead,
                d_ffn=intra_dffn, use_positional_encoding=intra_use_positional,
                norm_before=intra_norm_before, device=device)
        self.masknet = DualPathModel(
            in_channels=N, out_channels=N, intra_model=intra,
            inter_model=inter, num_layers=masknet_numlayers,
            norm=masknet_norm, K=masknet_chunksize, num_spks=masknet_numspks,
            skip_around_intra=masknet_extraskipconnection,
            linear_layer_after_inter_intra=masknet_useextralinearlayer,
            device=device)
        self.decoder = Decoder(kernel_size=encoder_kernel_size,
                               in_channels=N, device=device)

    def forward(self, mix):
        return apply_masks(self.encoder, self.masknet, self.decoder, mix)
