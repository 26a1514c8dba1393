"""Recurrent layers (port of ``speechbrain_tpu/nnet/RNN.py``): ``LSTM``,
``GRU``, ``RNN``, ``LiGRU``, ``SLiGRU``, ``QuasiRNN`` and the seq2seq
``AttentionalRNNDecoder``.

Layouts are batch-first, ``(batch, time, feature)``. A bidirectional layer
runs its backward direction over the whole padded time axis reversed, as
the JAX package's reversed scan does: lengths are not looked at and
sequences are not packed. Each layer's output is the concatenation
[forward, backward]; dropout between layers applies in training mode only.
The final states ``hn`` stack one entry per (layer, direction), index
``layer * dirs + direction``, and ``hx`` takes the same layout.

``LSTM``, ``GRU`` and ``RNN`` hand each layer to PyTorch's fused recurrent
kernels (``torch.lstm``/``torch.gru``/``torch.rnn_*``: cuDNN on the card)
with the JAX package's weights: its input projection ``wx`` (a ``Linear``
with bias) is ``weight_ih``/``bias_ih``, its recurrent matrix ``wh``
(stored ``(gates * H, H)`` here, transposed from flax's ``(H, gates * H)``)
is ``weight_hh``. The JAX LSTM and RNN have no recurrent bias, so theirs is
a zero buffer that no optimizer sees; the GRU's is its parameter ``bh``.
Gate orders are PyTorch's: i, f, g, o and r, z, n. ``LiGRU``, ``SLiGRU``
and ``QuasiRNN`` loop over time in plain PyTorch, after one product for
every step's input projection.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.linear import Linear


def _orthogonal(rows, cols, generator):
    """A (rows, cols) matrix with orthonormal rows or columns, drawn on the
    CPU from ``generator`` (flax's ``orthogonal`` initialiser's law)."""
    gen_device = generator.device if generator is not None else "cpu"
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    device=gen_device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if rows >= cols else q.t()


class _RNNBase(nn.Module):
    """The multi-layer, (bi)directional loop: per (layer, direction) an
    input projection ``wx`` and a recurrent matrix ``wh``; subclasses run
    one layer (both directions) in ``_run_layer``."""

    # gates per hidden unit; per-layer bias in wx
    n_gates = 1
    wx_bias = True

    def __init__(self, hidden_size, input_size, num_layers=1,
                 bidirectional=False, dropout=0.0, re_init=True,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dirs = 2 if bidirectional else 1
        self.dropout = dropout
        H, G = hidden_size, self.n_gates
        self.wx = nn.ModuleList()
        self.wh = nn.ParameterList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else H * self.dirs
            for _ in range(self.dirs):
                self.wx.append(Linear(G * H, in_size, bias=self.wx_bias,
                                      device=device, dtype=dtype,
                                      generator=generator))
                # flax's orthogonal (H, G*H), stored transposed
                self.wh.append(nn.Parameter(
                    _orthogonal(H, G * H, generator).t().contiguous()
                    .to(device=device, dtype=dtype)
                ))

    def index(self, layer, direction):
        return layer * self.dirs + direction

    def _zero_carry(self, batch, x):
        return x.new_zeros((self.dirs, batch, self.hidden_size))

    def _carry(self, hx, layer, batch, x):
        """(dirs, B, H) initial state of ``layer`` (a tuple for LSTM)."""
        if hx is None:
            return self._zero_carry(batch, x)
        sl = slice(layer * self.dirs, (layer + 1) * self.dirs)
        if isinstance(hx, tuple):
            return tuple(h[sl] for h in hx)
        return hx[sl]

    def _run_layer(self, layer, x, h0):
        """Returns (output (B, T, dirs*H), final state (dirs, B, H))."""
        raise NotImplementedError

    def forward(self, x, hx=None):
        B = x.shape[0]
        out, finals = x, []
        for layer in range(self.num_layers):
            out, h_last = self._run_layer(
                layer, out, self._carry(hx, layer, B, out)
            )
            finals.append(h_last)
            if (self.training and self.dropout > 0
                    and layer < self.num_layers - 1):
                out = F.dropout(out, self.dropout, training=True)
        if isinstance(finals[0], tuple):
            hn = tuple(torch.cat(parts) for parts in zip(*finals))
        else:
            hn = torch.cat(finals)
        return out, hn


class _FusedRNN(_RNNBase):
    """A layer through PyTorch's fused recurrent op (``_call``), both
    directions in one call. The recurrent bias is the parameter ``bh``
    where the JAX layer has one (``recurrent_bias``), else a zero buffer
    outside the state dict and the optimizer."""

    recurrent_bias = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        w = self.wh[0]
        zeros = lambda: torch.zeros(self.n_gates * self.hidden_size,
                                    device=w.device, dtype=w.dtype)
        if self.recurrent_bias:
            self.bh = nn.ParameterList(
                [nn.Parameter(zeros()) for _ in self.wx]
            )
        else:
            for i in range(len(self.wx)):
                self.register_buffer(f"zero_bh_{i}", zeros(),
                                     persistent=False)

    def _bh(self, i):
        if self.recurrent_bias:
            return self.bh[i]
        return getattr(self, f"zero_bh_{i}")

    def _run_layer(self, layer, x, h0):
        weights = []
        for d in range(self.dirs):
            i = self.index(layer, d)
            weights += [self.wx[i].weight, self.wh[i], self.wx[i].bias,
                        self._bh(i)]
        # one dtype for the op (the input's, under autocast too)
        weights = [w.to(x.dtype) for w in weights]
        if isinstance(h0, tuple):
            h0 = tuple(h.to(x.dtype) for h in h0)
        else:
            h0 = h0.to(x.dtype)
        out, *h = self._call(x, h0, weights)
        return out, (tuple(h) if len(h) > 1 else h[0])


class LSTM(_FusedRNN):
    """Multi-layer (bi)LSTM on ``(batch, time, feature)``; ``hx`` and
    ``hn`` are ``(h, c)``, each ``(layers * dirs, batch, hidden)``.

    Example
    -------
    >>> net = LSTM(hidden_size=5, input_size=20, device="cpu")
    >>> out, (h, c) = net(torch.ones(4, 10, 20))
    >>> out.shape, h.shape
    (torch.Size([4, 10, 5]), torch.Size([1, 4, 5]))
    """

    n_gates = 4

    def _zero_carry(self, batch, x):
        z = super()._zero_carry(batch, x)
        return (z, z)

    def _call(self, x, h0, weights):
        return torch.lstm(x, h0, weights, True, 1, 0.0, self.training,
                          self.bidirectional, True)


class GRU(_FusedRNN):
    """Multi-layer (bi)GRU; its recurrent bias is the parameter ``bh``
    (``n = tanh(x_n + r * (h W_hn + b_hn))``, PyTorch's formula).

    Example
    -------
    >>> net = GRU(hidden_size=5, input_size=20, bidirectional=True,
    ...           device="cpu")
    >>> net(torch.ones(4, 10, 20))[0].shape
    torch.Size([4, 10, 10])
    """

    n_gates = 3
    recurrent_bias = True

    def _call(self, x, h0, weights):
        return torch.gru(x, h0, weights, True, 1, 0.0, self.training,
                         self.bidirectional, True)


class RNN(_FusedRNN):
    """Multi-layer vanilla (bi)RNN with a ``tanh`` or ``relu``
    non-linearity.

    Example
    -------
    >>> net = RNN(hidden_size=5, input_size=20, device="cpu")
    >>> net(torch.ones(4, 10, 20))[0].shape
    torch.Size([4, 10, 5])
    """

    def __init__(self, *args, nonlinearity="tanh", **kwargs):
        super().__init__(*args, **kwargs)
        self.nonlinearity = nonlinearity

    def _call(self, x, h0, weights):
        op = torch.rnn_tanh if self.nonlinearity == "tanh" else torch.rnn_relu
        return op(x, h0, weights, True, 1, 0.0, self.training,
                  self.bidirectional, True)


def _scan(cell, h0, gx, reverse):
    """Run ``h = cell(h, gx[:, t])`` over time (backwards with
    ``reverse``); returns (last h, outputs (B, T, H) in time order)."""
    T = gx.shape[1]
    steps = range(T - 1, -1, -1) if reverse else range(T)
    h, ys = h0, [None] * T
    for t in steps:
        h = cell(h, gx[:, t])
        ys[t] = h
    return h, torch.stack(ys, dim=1)


class LiGRU(_RNNBase):
    """Light GRU: one update gate, a ``relu`` (or ``tanh``, ``sin``)
    candidate, no reset gate, and the input projection (no bias)
    batch-normalised over every step at once (``normalization=
    "batchnorm"``, or ``"layernorm"``).

    Example
    -------
    >>> net = LiGRU(hidden_size=5, input_size=20, device="cpu")
    >>> net(torch.ones(4, 10, 20))[0].shape
    torch.Size([4, 10, 5])
    """

    n_gates = 2
    wx_bias = False

    def __init__(self, *args, nonlinearity="relu", normalization="batchnorm",
                 **kwargs):
        super().__init__(*args, **kwargs)
        from speechbrain_tpu_torch.nnet.normalization import (
            BatchNorm1d,
            LayerNorm,
        )

        self.nonlinearity = nonlinearity
        self.normalization = normalization
        device, dtype = self.wh[0].device, self.wh[0].dtype
        width = self.n_gates * self.hidden_size
        if normalization == "batchnorm":
            norm = lambda: BatchNorm1d(width, device=device, dtype=dtype)
        elif normalization == "layernorm":
            norm = lambda: LayerNorm(width, device=device, dtype=dtype)
        else:
            norm = None
        self.norm = nn.ModuleList(
            [norm() for _ in self.wx] if norm is not None else []
        )
        self.act = {"relu": torch.relu, "tanh": torch.tanh,
                    "sin": torch.sin}[nonlinearity]

    def _project(self, i, x):
        gx = self.wx[i](x)
        return self.norm[i](gx) if len(self.norm) else gx

    def _cell(self, i):
        wh, act = self.wh[i], self.act

        def cell(h, g):
            az, ah = (g + h @ wh.t()).chunk(2, dim=-1)
            z = torch.sigmoid(az)
            return z * h + (1 - z) * act(ah)

        return cell

    def _run_layer(self, layer, x, h0):
        outs, finals = [], []
        for d in range(self.dirs):
            i = self.index(layer, d)
            h_last, ys = _scan(self._cell(i), h0[d], self._project(i, x),
                               reverse=bool(d))
            outs.append(ys)
            finals.append(h_last)
        return torch.cat(outs, dim=-1), torch.stack(finals)


class SLiGRU(LiGRU):
    """Stabilised LiGRU: the recurrent product is normalised to zero mean
    and unit variance over its features (no affine, eps 1e-5) before the
    gates; the input projection is always batch-normalised and the
    candidate is always ``relu``.

    Example
    -------
    >>> net = SLiGRU(hidden_size=5, input_size=20, device="cpu")
    >>> net(torch.ones(4, 10, 20))[0].shape
    torch.Size([4, 10, 5])
    """

    def __init__(self, *args, **kwargs):
        kwargs.update(nonlinearity="relu", normalization="batchnorm")
        super().__init__(*args, **kwargs)

    def _cell(self, i):
        wh = self.wh[i]

        def cell(h, g):
            gh = h @ wh.t()
            mean = gh.mean(-1, keepdim=True)
            var = ((gh - mean) ** 2).mean(-1, keepdim=True)
            gh = (gh - mean) * torch.rsqrt(var + 1e-5)
            az, ah = (g + gh).chunk(2, dim=-1)
            z = torch.sigmoid(az)
            return z * h + (1 - z) * torch.relu(ah)

        return cell


class QuasiRNN(nn.Module):
    """Quasi-RNN: gates from a causal convolution over time, then the
    fo-pooling recurrence ``c_t = f_t c_{t-1} + (1 - f_t) z_t`` from
    ``c_{-1} = 0``, and ``h = sigmoid(o) * c`` with ``output_gate``. The
    backward direction runs on the time-reversed input. ``hx`` is not
    read (the JAX package's neither); ``hn`` stacks each (layer,
    direction)'s last ``c``.

    Example
    -------
    >>> net = QuasiRNN(hidden_size=6, input_size=8, device="cpu")
    >>> out, h = net(torch.ones(2, 12, 8))
    >>> out.shape, h.shape
    (torch.Size([2, 12, 6]), torch.Size([1, 2, 6]))
    """

    def __init__(self, hidden_size, input_size, num_layers=1, kernel_size=2,
                 bidirectional=False, zoneout=0.0, output_gate=True,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        from speechbrain_tpu_torch.nnet.CNN import Conv1d

        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dirs = 2 if bidirectional else 1
        self.output_gate = output_gate
        n_gates = 3 if output_gate else 2
        self.conv = nn.ModuleList()
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * self.dirs
            for _ in range(self.dirs):
                self.conv.append(Conv1d(
                    out_channels=n_gates * hidden_size,
                    kernel_size=kernel_size, in_channels=in_size,
                    padding="causal", device=device, dtype=dtype,
                    generator=generator,
                ))

    def forward(self, x, hx=None):
        out, finals = x, []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.dirs):
                inp = out if d == 0 else out.flip(1)
                gates = self.conv[layer * self.dirs + d](inp)
                gates = gates.chunk(3 if self.output_gate else 2, dim=-1)
                z, f = torch.tanh(gates[0]), torch.sigmoid(gates[1])
                c = torch.zeros_like(z[:, 0])
                cs = []
                for t in range(z.shape[1]):
                    c = f[:, t] * c + (1 - f[:, t]) * z[:, t]
                    cs.append(c)
                c = torch.stack(cs, dim=1)
                h = torch.sigmoid(gates[2]) * c if self.output_gate else c
                outs.append(h.flip(1) if d == 1 else h)
                finals.append(c[:, -1])
            out = torch.cat(outs, dim=-1)
        return out, torch.stack(finals)


class AttentionalRNNDecoder(nn.Module):
    """GRU decoder with content, location-aware or key-value attention,
    the CRDNN seq2seq decoder. Each step feeds ``[token embedding,
    previous context]`` through ``num_layers`` GRU cells, attends over the
    encoder states with the top cell's output, and projects
    ``[context, cell output]`` to ``hidden_size``. Contexts have
    ``attn_dim`` features. ``rnn_type`` and ``dropout`` are taken and not
    read, as in the JAX package (its cell is always a GRU).

    ``forward_step`` takes and returns an explicit state dict whose
    tensors are batch-leading (``hidden`` (B, layers, H), ``context``
    (B, attn_dim), ``prev_attn`` (B, T) or None), so that a beam search
    permutes it with one gather along axis 0; ``forward`` teacher-forces
    a whole sequence.

    Example
    -------
    >>> dec = AttentionalRNNDecoder(hidden_size=8, attn_dim=6, input_size=4,
    ...                             enc_dim=5, kernel_size=2, device="cpu")
    >>> out, attn = dec(torch.ones(2, 3, 4), torch.ones(2, 7, 5),
    ...                 torch.ones(2))
    >>> out.shape, attn.shape
    (torch.Size([2, 3, 8]), torch.Size([2, 3, 7]))
    """

    def __init__(self, hidden_size, attn_dim, input_size, enc_dim,
                 num_layers=1, rnn_type="gru", attn_type="location",
                 scaling=1.0, channels=10, kernel_size=100, dropout=0.0,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        from speechbrain_tpu_torch.nnet.attention import (
            ContentBasedAttention,
            KeyValueAttention,
            LocationAwareAttention,
        )

        kw = dict(device=device, dtype=dtype, generator=generator)
        self.hidden_size = hidden_size
        self.attn_dim = attn_dim
        self.num_layers = num_layers
        self.attn_type = attn_type
        H = hidden_size
        if attn_type == "content":
            self.attn = ContentBasedAttention(
                enc_dim, H, attn_dim, attn_dim, scaling=scaling, **kw)
        elif attn_type == "location":
            self.attn = LocationAwareAttention(
                enc_dim, H, attn_dim, attn_dim, conv_channels=channels,
                kernel_size=kernel_size, scaling=scaling, **kw)
        elif attn_type == "keyvalue":
            self.attn = KeyValueAttention(enc_dim, H, attn_dim, attn_dim,
                                          **kw)
        else:
            raise ValueError(f"Unknown attn_type {attn_type}")
        self.proj = Linear(H, attn_dim + H, **kw)
        self.wx = nn.ModuleList([
            Linear(3 * H, (input_size + attn_dim) if layer == 0 else H, **kw)
            for layer in range(num_layers)
        ])
        self.wh = nn.ParameterList([
            nn.Parameter(_orthogonal(H, 3 * H, generator).t().contiguous()
                         .to(device=device, dtype=dtype))
            for _ in range(num_layers)
        ])
        self.bh = nn.ParameterList([
            nn.Parameter(torch.zeros(3 * H, device=device, dtype=dtype))
            for _ in range(num_layers)
        ])

    def init_state(self, batch, enc_T, dtype=torch.float32, device=None):
        """The state before the first step (``prev_attn`` None: the
        location-aware attention starts from uniform weights)."""
        device = device or self.bh[0].device
        return {
            "hidden": torch.zeros((batch, self.num_layers, self.hidden_size),
                                  dtype=dtype, device=device),
            "context": torch.zeros((batch, self.attn_dim), dtype=dtype,
                                   device=device),
            "prev_attn": None,
        }

    def forward_step(self, inp, state, enc_states, enc_len):
        """One step: ``inp`` (B, E) token embedding -> (output (B, H),
        new state, attention weights (B, T))."""
        x = torch.cat([inp, state["context"].to(inp.dtype)], dim=-1)
        hs = []
        for layer in range(self.num_layers):
            wx = self.wx[layer]
            x = torch.gru_cell(
                x, state["hidden"][:, layer].to(x.dtype),
                wx.weight.to(x.dtype), self.wh[layer].to(x.dtype),
                wx.bias.to(x.dtype), self.bh[layer].to(x.dtype),
            )
            hs.append(x)
        if self.attn_type == "location":
            context, attn = self.attn(enc_states, enc_len, x,
                                      prev_attn=state.get("prev_attn"))
        else:
            context, attn = self.attn(enc_states, enc_len, x)
        out = self.proj(torch.cat([context.to(x.dtype), x], dim=-1))
        new_state = {"hidden": torch.stack(hs, dim=1), "context": context,
                     "prev_attn": attn}
        return out, new_state, attn

    def forward(self, inp_seq, enc_states, enc_len):
        """Teacher-forced decode: ``inp_seq`` (B, U, E) -> (outputs
        (B, U, H), attention weights (B, U, T))."""
        from speechbrain_tpu_torch.nnet.attention import uniform_attention

        B, U, _ = inp_seq.shape
        T = enc_states.shape[1]
        state = self.init_state(B, T, inp_seq.dtype, inp_seq.device)
        state["prev_attn"] = uniform_attention(enc_len, T, inp_seq.dtype)
        outs, attns = [], []
        for u in range(U):
            out, state, attn = self.forward_step(inp_seq[:, u], state,
                                                 enc_states, enc_len)
            outs.append(out)
            attns.append(attn)
        return torch.stack(outs, dim=1), torch.stack(attns, dim=1)
