"""Signal-processing helpers (port of ``overlap_and_add`` from
``speechbrain_tpu/processing/signal_processing.py``; the rest of that
module is not ported yet)."""

import torch.nn.functional as F


def overlap_and_add(signal, frame_step):
    """Rebuild a signal from its frames ``(..., frames, frame_length)``:
    frame ``f`` is added at ``f * frame_step``, giving ``(...,
    (frames - 1) * frame_step + frame_length)``. One ``F.fold`` (col2im:
    each output sample sums the frames over it, with no atomics).

    Example
    -------
    >>> import torch
    >>> overlap_and_add(torch.ones(2, 3, 4), 2)
    tensor([[1., 1., 2., 2., 2., 2., 1., 1.],
            [1., 1., 2., 2., 2., 2., 1., 1.]])
    """
    frames, frame_length = signal.shape[-2:]
    lead = signal.shape[:-2]
    out_len = (frames - 1) * frame_step + frame_length
    cols = signal.reshape(-1, frames, frame_length).transpose(1, 2)
    out = F.fold(cols, output_size=(1, out_len), kernel_size=(1, frame_length),
                 stride=(1, frame_step))
    return out.reshape(*lead, out_len)
