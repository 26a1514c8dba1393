"""Transducer joint network (port of
``speechbrain_tpu/nnet/transducer_joint.py``): combine encoder states
(B, T, H_enc) and prediction-network states (B, U, H_dec) into
(B, T, U, joint_dim) by a sum or a concatenation, then a nonlinearity.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechbrain_tpu_torch.nnet.activations import get_activation
from speechbrain_tpu_torch.nnet.linear import Linear


class TransducerJoint(nn.Module):
    """Joint network: ``joint="sum"`` projects each side to ``joint_dim``
    (``enc_proj``, ``dec_proj``) and adds them broadcast over (T, U);
    ``joint="concat"`` applies one ``proj`` to the two sides concatenated
    over (T, U), computed as the sum of its two column blocks applied to
    each side, so that the (B, T, U, H_enc + H_dec) concatenation is never
    built. Inputs are 3-D, ``(B, T, H)`` and ``(B, U, H)``, or already
    expanded, ``(B, T, 1, H)`` and ``(B, 1, U, H)``.

    Example
    -------
    >>> joint = TransducerJoint(8, enc_dim=8, dec_dim=8, device="cpu")
    >>> joint(torch.ones(2, 10, 8), torch.ones(2, 4, 8)).shape
    torch.Size([2, 10, 4, 8])
    """

    def __init__(self, joint_dim, enc_dim, dec_dim, joint="sum",
                 nonlinearity="leaky_relu", device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.joint = joint
        self.enc_dim = enc_dim
        self.act = get_activation(nonlinearity)
        if joint == "sum":
            self.enc_proj = Linear(joint_dim, enc_dim, **kw)
            self.dec_proj = Linear(joint_dim, dec_dim, **kw)
        elif joint == "concat":
            self.proj = Linear(joint_dim, enc_dim + dec_dim, **kw)
        else:
            raise ValueError("joint must be 'sum' or 'concat'")

    def forward(self, input_TN, input_PN):
        if input_TN.ndim == 3:
            input_TN = input_TN[:, :, None, :]
        if input_PN.ndim == 3:
            input_PN = input_PN[:, None, :, :]
        if self.joint == "sum":
            joint = self.enc_proj(input_TN) + self.dec_proj(input_PN)
        else:
            w, b = self.proj.weight, self.proj.bias
            joint = (F.linear(input_TN, w[:, :self.enc_dim])
                     + F.linear(input_PN, w[:, self.enc_dim:], b))
        return self.act(joint)
