"""Inference interfaces: the ``Pretrained`` base and the task interfaces
(port of ``speechbrain_tpu/inference``)."""

from speechbrain_tpu_torch.inference.interfaces import (  # noqa: F401
    Pretrained,
    foreign_class,
)
