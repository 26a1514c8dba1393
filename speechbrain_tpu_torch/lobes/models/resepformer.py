"""RE-SepFormer and SkiM, resource-efficient separation (port of
``speechbrain_tpu/lobes/models/resepformer.py``): the encoded mixture is
cut into segments of ``segment_size`` frames; each block processes every
segment on its own (a Transformer for RE-SepFormer, an LSTM for SkiM)
while a memory carries information between segments: the ``"av"``
memory, a Transformer over each segment's mean, or the SkiM LSTM states
(``"hc"``, ``"h"``, ``"c"``, ``"id"``).

The ``"av"`` memory attends over the segments of each batch item alone,
as the JAX package does (upstream flattens batch and segments into one
sequence). Recurrent states are ``(layers * dirs, B * S, H)``, batch on
axis 1, as the port's LSTM takes them. Submodules carry the flax scopes'
names, so ``utils/jax_bridge.py`` loads the JAX trees by name.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.lobes.models.dual_path import (
    Decoder,
    Encoder,
    pad_or_trim,
)
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.RNN import LSTM


def _global_layer_norm(x, scale, bias, eps=1e-8):
    """gLN of (B, T, D) over its (time, channel) axes."""
    mean = x.mean((1, 2), keepdim=True)
    var = ((x - mean) ** 2).mean((1, 2), keepdim=True)
    return scale * (x - mean) / torch.sqrt(var + eps) + bias


class _SepNorm(nn.Module):
    """The segment models' norm of (B, T, D): ``"gln"`` over (time,
    channel), ``"cln"`` over the channels of each frame (causal-safe);
    eps 1e-8, a scale and a bias of (1, 1, D)."""

    def __init__(self, input_size, norm_type="gln", device="cuda"):
        super().__init__()
        self.norm_type = norm_type
        self.scale = nn.Parameter(torch.ones(1, 1, input_size, device=device))
        self.bias = nn.Parameter(torch.zeros(1, 1, input_size, device=device))

    def forward(self, x):
        if self.norm_type == "gln":
            return _global_layer_norm(x, self.scale, self.bias)
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return self.scale * (x - mean) / torch.sqrt(var + 1e-8) + self.bias


class SBTransformerBlockWNormAndSkip(nn.Module):
    """A post-norm ``TransformerEncoder`` (causal where ``causal``), its
    ``_SepNorm`` and a skip connection."""

    def __init__(self, num_layers, d_model, nhead, d_ffn=2048, dropout=0.1,
                 use_norm=True, use_skip=True, norm_type="gln", causal=False,
                 device="cuda"):
        super().__init__()
        self.use_skip = use_skip
        self.causal = causal
        self.mdl = TransformerEncoder(num_layers=num_layers, nhead=nhead,
                                      d_ffn=d_ffn, d_model=d_model,
                                      dropout=dropout, device=device)
        self.norm = (_SepNorm(d_model, norm_type, device=device)
                     if use_norm else None)

    def forward(self, x):
        src_mask = (get_lookahead_mask(x.shape[1], x.device) if self.causal
                    else None)
        out = self.mdl(x, src_mask=src_mask)[0]
        if self.norm is not None:
            out = self.norm(out)
        return out + x if self.use_skip else out


class SegLSTM(nn.Module):
    """SkiM's segment LSTM: one LSTM layer over each segment from the
    memory's (h, c) (zeros where none), dropout in training, a projection
    back to the input width, ``_SepNorm`` and a residual. Returns
    ``(out, (h, c))``."""

    def __init__(self, input_size, hidden_size, dropout=0.0,
                 bidirectional=False, norm_type="gln", device="cuda"):
        super().__init__()
        self.dropout = dropout
        dirs = 2 if bidirectional else 1
        self.lstm = LSTM(hidden_size=hidden_size, input_size=input_size,
                         bidirectional=bidirectional, device=device)
        self.proj = Linear(input_size, input_size=dirs * hidden_size,
                           device=device)
        self.norm = _SepNorm(input_size, norm_type, device=device)

    def forward(self, x, hc=None):
        out, hc = self.lstm(x, hc)
        out = F.dropout(out, self.dropout, self.training)
        return x + self.norm(self.proj(out)), hc


class MemLSTM(nn.Module):
    """SkiM's memory: each segment's final LSTM states, ``(dirs, B * S,
    H)``, run as sequences over the S segments of each batch item through
    an LSTM, a projection and ``_SepNorm`` with a residual (``"hc"`` both
    states, ``"h"`` or ``"c"`` one and the other zeroed, ``"id"`` none);
    where one-directional, shifted by one segment so that segment s reads
    the memory of segment s - 1."""

    def __init__(self, hidden_size, dropout=0.0, bidirectional=False,
                 mem_type="hc", norm_type="cln", device="cuda"):
        super().__init__()
        self.bidirectional = bidirectional
        self.mem_type = mem_type
        dirs = 2 if bidirectional else 1
        width = dirs * hidden_size
        for prefix in ("h", "c"):
            if mem_type in ("hc", prefix):
                self.add_module(f"{prefix}_net", LSTM(
                    hidden_size=hidden_size, input_size=width,
                    bidirectional=bidirectional, device=device))
                self.add_module(f"{prefix}_proj", Linear(
                    width, input_size=width, device=device))
                self.add_module(f"{prefix}_norm", _SepNorm(
                    width, norm_type, device=device))

    def _mem(self, seq, prefix):
        out = getattr(self, f"{prefix}_net")(seq)[0]
        out = getattr(self, f"{prefix}_proj")(out)
        return seq + getattr(self, f"{prefix}_norm")(out)

    def forward(self, hc, S):
        if self.mem_type != "id":
            h, c = hc
            d, BS, H = h.shape
            B = BS // S
            h_seq = h.transpose(0, 1).reshape(B, S, d * H)
            c_seq = c.transpose(0, 1).reshape(B, S, d * H)
            if self.mem_type in ("hc", "h"):
                h_seq = self._mem(h_seq, "h")
            if self.mem_type in ("hc", "c"):
                c_seq = self._mem(c_seq, "c")
            if self.mem_type == "h":
                c_seq = torch.zeros_like(c_seq)
            if self.mem_type == "c":
                h_seq = torch.zeros_like(h_seq)
            hc = (h_seq.reshape(B * S, d, H).transpose(0, 1),
                  c_seq.reshape(B * S, d, H).transpose(0, 1))
        if not self.bidirectional:
            hc = tuple(self._shift(x, S) for x in hc)
        # cuDNN's LSTM takes dense initial states only
        return tuple(x.contiguous() for x in hc)

    @staticmethod
    def _shift(x, S):
        d, BS, H = x.shape
        xs = x.transpose(0, 1).reshape(BS // S, S, d, H)
        xs = F.pad(xs, (0, 0, 0, 0, 1, 0))[:, :-1]
        return xs.reshape(BS, d, H).transpose(0, 1)


class ResourceEfficientSeparationPipeline(nn.Module):
    """Segment, process with memory, merge: (B, T, D) -> (B, T,
    output_size). ``num_blocks`` segment models (``seg_model``
    "transformer" or "lstm"), a memory between consecutive ones
    (``mem_type`` "av" with the Transformer, an LSTM kind with the LSTM),
    then a PReLU of slope 0.25 and ``output_fc``."""

    def __init__(self, input_size, hidden_size, output_size, num_blocks=2,
                 segment_size=20, bidirectional=True, mem_type="av",
                 norm_type="gln", seg_model="transformer", nhead=8,
                 d_ffn=1024, seg_num_layers=1, dropout=0.0, device="cuda"):
        super().__init__()
        self.num_blocks = num_blocks
        self.segment_size = segment_size
        self.mem_type = mem_type
        self.seg_model = seg_model

        def transformer():
            return SBTransformerBlockWNormAndSkip(
                num_layers=seg_num_layers, d_model=input_size, nhead=nhead,
                d_ffn=d_ffn, dropout=dropout, norm_type=norm_type,
                causal=not bidirectional, device=device)

        for i in range(num_blocks):
            if seg_model == "transformer":
                seg = transformer()
            else:
                seg = SegLSTM(input_size, hidden_size, dropout=dropout,
                              bidirectional=bidirectional,
                              norm_type=norm_type, device=device)
            self.add_module(f"seg_{i}", seg)
            if i == num_blocks - 1:
                continue
            if mem_type == "av":
                self.add_module(f"mem_{i}", transformer())
            elif mem_type is not None:
                self.add_module(f"mem_{i}", MemLSTM(
                    hidden_size, dropout=dropout,
                    bidirectional=bidirectional, mem_type=mem_type,
                    norm_type=norm_type, device=device))
        self.output_fc = Linear(output_size, input_size=input_size,
                                device=device)

    def forward(self, x):
        B, T, D = x.shape
        K = self.segment_size
        x = F.pad(x, (0, 0, 0, (-T) % K))
        S = x.shape[1] // K
        out = x.reshape(B * S, K, D)
        hc = None
        if self.mem_type == "av":
            hc = out.new_zeros(B * S, 1, D)
        for i in range(self.num_blocks):
            seg = getattr(self, f"seg_{i}")
            if self.seg_model == "transformer":
                out = seg(out + hc if hc is not None else out)
            else:
                out, hc = seg(out, hc)
            if i == self.num_blocks - 1 or self.mem_type is None:
                continue
            mem = getattr(self, f"mem_{i}")
            if self.mem_type == "av":
                summary = mem(out.mean(1).reshape(B, S, D))
                hc = summary.reshape(B * S, 1, D)
            else:
                hc = mem(hc, S)
        out = out.reshape(B, S * K, D)[:, :T]
        out = torch.where(out > 0, out, 0.25 * out)
        return self.output_fc(out)


_NONLINEAR = {"relu": F.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


class ResourceEfficientSeparator(nn.Module):
    """RE-SepFormer's mask network: encoded mixture (B, T, N) -> masks
    (B, n_spk, T, N).

    Example
    -------
    >>> sep = ResourceEfficientSeparator(input_dim=16, num_spk=2, unit=16,
    ...     layer=2, segment_size=10, mem_type="av", nhead=4, device="cpu")
    >>> sep(torch.ones(2, 50, 16)).shape
    torch.Size([2, 2, 50, 16])
    """

    def __init__(self, input_dim, causal=True, num_spk=2, nonlinear="relu",
                 layer=3, unit=512, segment_size=20, dropout=0.0,
                 mem_type="hc", seg_model="transformer", nhead=8, d_ffn=1024,
                 device="cuda"):
        super().__init__()
        self.num_spk = num_spk
        self.nonlinear = _NONLINEAR[nonlinear]
        self.model = ResourceEfficientSeparationPipeline(
            input_size=input_dim, hidden_size=unit,
            output_size=input_dim * num_spk, num_blocks=layer,
            segment_size=segment_size, bidirectional=not causal,
            mem_type=mem_type, norm_type="cln" if causal else "gln",
            seg_model=seg_model, nhead=nhead, d_ffn=d_ffn, dropout=dropout,
            device=device)

    def forward(self, x):
        B, T, N = x.shape
        processed = self.model(x).reshape(B, T, N, self.num_spk)
        return self.nonlinear(processed).permute(0, 3, 1, 2)


class RESepformerWrapper(nn.Module):
    """Encoder + ``ResourceEfficientSeparator`` (non-causal) + decoder:
    mixture (B, T) -> sources (B, T, n_spks); ``seg_model="lstm"`` is
    SkiM.

    Example
    -------
    >>> model = RESepformerWrapper(encoder_kernel_size=16,
    ...     encoder_out_nchannels=16, masknet_chunksize=10,
    ...     masknet_numspks=2, device="cpu")
    >>> model(torch.ones(1, 800)).shape
    torch.Size([1, 800, 2])
    """

    def __init__(self, encoder_kernel_size=16, encoder_out_nchannels=256,
                 masknet_chunksize=100, masknet_numspks=2, n_layers=2,
                 nhead=4, d_ffn=256, mem_type="av", seg_model="transformer",
                 device="cuda"):
        super().__init__()
        N = encoder_out_nchannels
        self.num_spks = masknet_numspks
        self.encoder = Encoder(kernel_size=encoder_kernel_size,
                               out_channels=N, device=device)
        self.masknet = ResourceEfficientSeparator(
            input_dim=N, causal=False, num_spk=masknet_numspks,
            layer=n_layers, unit=N, segment_size=masknet_chunksize,
            mem_type=mem_type, nhead=nhead, d_ffn=d_ffn,
            seg_model=seg_model, device=device)
        self.decoder = Decoder(kernel_size=encoder_kernel_size,
                               in_channels=N, device=device)

    def forward(self, mix):
        enc = self.encoder(mix)
        masks = self.masknet(enc)
        est = torch.stack([self.decoder(enc * masks[:, s])
                           for s in range(self.num_spks)], dim=-1)
        return pad_or_trim(est, mix.shape[1])
