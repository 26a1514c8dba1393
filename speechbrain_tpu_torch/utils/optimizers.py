"""Optimizer helpers (port of ``speechbrain_tpu/utils/optimizers.py``):
leave 0-d and 1-D parameters (scalars, biases, norm scales) out of weight
decay, as two ``torch.optim`` param groups: the JAX package decays only
parameters with more than one dimension."""


def rm_vector_weight_decay(modules):
    """Param groups for a ``torch.optim`` optimizer: the 0-d and 1-D parameters
    of ``modules`` (an ``nn.Module`` or an iterable of parameters) with
    ``weight_decay`` 0, then the others with the optimizer's default.

    Example
    -------
    >>> import torch
    >>> groups = rm_vector_weight_decay(torch.nn.Linear(3, 4))
    >>> [(len(g["params"]), g.get("weight_decay")) for g in groups]
    [(1, 0.0), (1, None)]
    """
    params = modules.parameters() if hasattr(modules, "parameters") \
        else modules
    decay, no_decay = [], []
    for p in params:
        (no_decay if p.ndim <= 1 else decay).append(p)
    return [{"params": no_decay, "weight_decay": 0.0}, {"params": decay}]
