"""RNN language model (port of ``speechbrain_tpu/lobes/models/RNNLM.py``):
embedding, LSTM stack, DNN blocks, output logits; pass ``hx`` and read the
returned state for step-by-step calls (shallow fusion in beam search).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.embedding import Embedding
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.nnet.normalization import LayerNorm
from speechbrain_tpu_torch.nnet.RNN import LSTM


class RNNLM(nn.Module):
    """``(B, U)`` token ids -> ``(B, U, vocab)`` logits and the LSTM's
    ``(h, c)`` state (each ``(rnn_layers, B, rnn_neurons)``), or the logits
    alone when ``return_hidden`` is false.

    Example
    -------
    >>> lm = RNNLM(output_neurons=50, embedding_dim=16, rnn_neurons=32,
    ...            dnn_neurons=32, device="cpu").eval()
    >>> logits, (h, c) = lm(torch.ones(2, 6, dtype=torch.long))
    >>> logits.shape, h.shape
    (torch.Size([2, 6, 50]), torch.Size([2, 2, 32]))
    """

    def __init__(self, output_neurons, embedding_dim=128,
                 activation="leaky_relu", dropout=0.15, rnn_layers=2,
                 rnn_neurons=1024, dnn_blocks=1, dnn_neurons=512,
                 return_hidden=True, device="cuda", dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.act = get_activation(activation)
        self.dropout = dropout
        self.return_hidden = return_hidden
        self.emb = Embedding(output_neurons, embedding_dim,
                             generator=generator, **kw)
        self.rnn = LSTM(hidden_size=rnn_neurons, input_size=embedding_dim,
                        num_layers=rnn_layers, dropout=dropout,
                        generator=generator, **kw)
        self.dnn = nn.ModuleList()
        self.norm = nn.ModuleList()
        width = rnn_neurons
        for _ in range(dnn_blocks):
            self.dnn.append(Linear(dnn_neurons, width, generator=generator,
                                   **kw))
            self.norm.append(LayerNorm(dnn_neurons, **kw))
            width = dnn_neurons
        self.out = Linear(output_neurons, width, generator=generator, **kw)

    def forward(self, x, hx=None):
        out, state = self.rnn(self.emb(x), hx=hx)
        for lin, norm in zip(self.dnn, self.norm):
            out = self.act(norm(lin(out)))
            if self.training and self.dropout > 0:
                out = F.dropout(out, self.dropout, training=True)
        logits = self.out(out)
        if self.return_hidden:
            return logits, state
        return logits
