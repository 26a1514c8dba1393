"""Data utilities (port of ``pad_time_to_multiple`` from
``speechbrain_tpu/utils/data_utils.py``)."""

import torch.nn.functional as F


def pad_time_to_multiple(x, lengths=None, multiple=128, value=0.0):
    """Pad the time axis (axis 1) of a (B, T, ...) tensor to a multiple
    and rescale relative lengths to the new T.

    Example
    -------
    >>> import torch
    >>> x, lens = pad_time_to_multiple(torch.ones(2, 251, 4),
    ...                                torch.ones(2), multiple=128)
    >>> x.shape[1], float(lens[0])
    (256, 0.98046875)
    """
    T = x.shape[1]
    pad = (-T) % multiple
    if pad == 0:
        return x, lengths
    pads = [0, 0] * (x.ndim - 2) + [0, pad]
    x = F.pad(x, pads, value=value)
    if lengths is not None:
        lengths = lengths * (T / (T + pad))
    return x, lengths
