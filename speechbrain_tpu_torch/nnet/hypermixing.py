"""HyperMixing: token mixing with hypernetwork-generated MLPs, a
linear-complexity alternative to self-attention (port of
``speechbrain_tpu/nnet/hypermixing.py``: ``HyperNetwork`` and
``HyperMixing``). The call signature mirrors ``MultiheadAttention`` so that
it can stand in for it in a transformer layer.
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.nnet.activations import gelu
from speechbrain_tpu_torch.nnet.linear import Linear


class HyperNetwork(nn.Module):
    """Generate per-position token-mixing weights W1 and W2, each
    (B, H, T, hypernet_size); ``tied`` makes W2 the same as W1."""

    def __init__(self, hypernet_size, input_output_dim, tied=False,
                 num_heads=1, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.hypernet_size = hypernet_size
        self.num_heads = num_heads
        self.tied = tied
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.w1_gen = Linear(hypernet_size * num_heads, input_output_dim, **kw)
        self.w2_gen = None if tied else Linear(
            hypernet_size * num_heads, input_output_dim, **kw
        )

    def _heads(self, w):
        B, T, _ = w.shape
        return w.reshape(
            B, T, self.num_heads, self.hypernet_size
        ).transpose(1, 2)

    def forward(self, x):
        w1 = self._heads(self.w1_gen(x))
        w2 = w1 if self.tied else self._heads(self.w2_gen(x))
        return w1, w2


class HyperMixing(nn.Module):
    """Token mixing through a hypernetwork MLP: the hypernetwork reads
    ``query``, the MLP mixes ``value`` over time (GELU in its tanh form, as
    ``jax.nn.gelu``). Padded positions (``key_padding_mask``, True =
    padded) get zero weights. Returns ``(output, None)``.

    Example
    -------
    >>> hm = HyperMixing(input_output_dim=16, hypernet_size=32, num_heads=2,
    ...                  device="cpu")
    >>> x = torch.ones(2, 10, 16)
    >>> out, w = hm(x, x, x)
    >>> out.shape, w
    (torch.Size([2, 10, 16]), None)
    """

    def __init__(self, input_output_dim, hypernet_size, tied=False,
                 num_heads=1, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        if input_output_dim % num_heads:
            raise ValueError("input_output_dim must be a multiple of "
                             "num_heads")
        self.input_output_dim = input_output_dim
        self.num_heads = num_heads
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.hyper = HyperNetwork(
            hypernet_size=hypernet_size, input_output_dim=input_output_dim,
            tied=tied, num_heads=num_heads, **kw,
        )
        self.out_proj = Linear(input_output_dim, input_output_dim, **kw)

    def forward(self, query, key, value, attn_mask=None,
                key_padding_mask=None, pos_embs=None):
        x = value
        B, T, D = x.shape
        H = self.num_heads
        w1, w2 = self.hyper(query)
        if key_padding_mask is not None:
            keep = (~key_padding_mask).to(w1.dtype)[:, None, :, None]
            w1 = w1 * keep
            w2 = w2 * keep
        xh = x.reshape(B, T, H, D // H).transpose(1, 2)  # (B, H, T, hd)
        # token-mixing MLP: act(W1^T x), then W2
        hidden = gelu(torch.matmul(w1.transpose(-1, -2), xh))  # (B,H,hs,hd)
        out = torch.matmul(w2, hidden)  # (B, H, T, hd)
        out = out.transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out), None
