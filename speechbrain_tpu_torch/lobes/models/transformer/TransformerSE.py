"""Transformer speech-enhancement masker (port of
``speechbrain_tpu/lobes/models/transformer/TransformerSE.py``:
``CNNTransformerSE``).
"""

import torch
import torch.nn as nn

from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    TransformerEncoder,
    get_lookahead_mask,
)
from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.linear import Linear


class CNNTransformerSE(nn.Module):
    """(batch, time, input_size) -> (batch, time, output_size): an
    optional ``custom_emb_module``, ``proj_in`` to ``d_model``, a
    Transformer encoder (causal self-attention where ``causal``),
    ``proj_out`` and ``output_activation``. ``input_size`` is the width
    that reaches ``proj_in`` (``output_size`` when not given).

    Example
    -------
    >>> net = CNNTransformerSE(d_model=16, num_layers=1, nhead=4, d_ffn=32,
    ...                        output_size=20, device="cpu")
    >>> net(torch.ones(2, 10, 20)).shape
    torch.Size([2, 10, 20])
    """

    def __init__(self, d_model=256, num_layers=8, nhead=8, d_ffn=512,
                 output_size=257, output_activation="relu", causal=True,
                 custom_emb_module=None, input_size=None, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.causal = causal
        self.output_activation = get_activation(output_activation)
        self.custom_emb_module = custom_emb_module
        self.proj_in = Linear(d_model, input_size or output_size, **kw)
        self.encoder = TransformerEncoder(
            num_layers=num_layers, nhead=nhead, d_ffn=d_ffn, d_model=d_model,
            **kw)
        self.proj_out = Linear(output_size, d_model, **kw)

    def forward(self, x, src_key_padding_mask=None):
        if self.custom_emb_module is not None:
            x = self.custom_emb_module(x)
        x = self.proj_in(x)
        mask = (get_lookahead_mask(x.shape[1], device=x.device)
                if self.causal else None)
        out, _ = self.encoder(x, src_mask=mask,
                              src_key_padding_mask=src_key_padding_mask)
        return self.output_activation(self.proj_out(out))
