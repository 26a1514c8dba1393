"""Transducer (RNN-T) loss under the reference's module name.

The reference's ``speechbrain/integrations/numba/transducer_loss.py``
holds a Numba CUDA kernel. The port computes the loss in plain PyTorch,
row by row over time with a log-semiring scan over the labels, in
:mod:`speechbrain_tpu_torch.nnet.transducer_loss`; this module re-exports
it so that recipe imports keep working.
"""

from speechbrain_tpu_torch.nnet.transducer_loss import (  # noqa: F401
    TransducerLoss,
    transducer_loss,
)
