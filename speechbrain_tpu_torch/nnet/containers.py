"""Containers that chain layers (port of ``speechbrain_tpu/nnet/containers.py``:
``lengths_arg_exists``, ``Sequential``, ``LengthsCapableSequential``,
``ModuleList``, ``ConnectBlocks``).

A layer is an ``nn.Module`` or any callable (a feature extractor, a
function); the modules among them are registered under their position, so
``state_dict`` keys read ``"<position>.<name>"`` as ``torch.nn.Sequential``'s
do, and ``.to``/``.eval`` reach them.
"""

import inspect

import torch.nn as nn

from speechbrain_tpu_torch.nnet.linear import Linear


def lengths_arg_exists(func):
    """True if ``func`` takes an argument named ``lengths``.

    Example
    -------
    >>> lengths_arg_exists(lambda x, lengths=None: x)
    True
    >>> lengths_arg_exists(abs)
    False
    """
    try:
        spec = inspect.signature(func)
    except (TypeError, ValueError):
        return False
    return "lengths" in spec.parameters


class _Chain(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = tuple(layers)
        for i, layer in enumerate(self.layers):
            if isinstance(layer, nn.Module):
                self.add_module(str(i), layer)


class Sequential(_Chain):
    """Apply ``layers`` in order to one input.

    Example
    -------
    >>> import torch
    >>> net = Sequential([Linear(16, 8, device="cpu"), torch.relu,
    ...                   Linear(4, 16, device="cpu")])
    >>> net(torch.ones(2, 5, 8)).shape
    torch.Size([2, 5, 4])
    """

    def forward(self, x, **kwargs):
        for layer in self.layers:
            x = layer(x)
        return x


class LengthsCapableSequential(_Chain):
    """A ``Sequential`` that passes ``lengths`` to each layer that takes
    an argument of that name.

    A layer may return ``(x, lengths)``: the layers after it get the new
    lengths, and the chain returns ``(x, lengths)``. That is how a layer
    that pads the time axis (``utils/data_utils.pad_time_to_multiple``)
    hands its rescaled relative lengths on to an encoder's masks and to
    whoever reads the chain's output. (The reference keeps the first
    element of a tuple and drops the rest; the JAX package takes no
    tuples.)

    Example
    -------
    >>> import functools, torch
    >>> from speechbrain_tpu_torch.utils.data_utils import (
    ...     pad_time_to_multiple)
    >>> net = LengthsCapableSequential([
    ...     functools.partial(pad_time_to_multiple, multiple=8),
    ...     lambda x, lengths: x * lengths[:, None, None]])
    >>> x, lens = net(torch.ones(2, 6, 3), lengths=torch.tensor([1., .5]))
    >>> x.shape, lens.tolist()
    (torch.Size([2, 8, 3]), [0.75, 0.375])
    """

    def forward(self, x, lengths=None):
        new_lengths = False
        for layer in self.layers:
            fn = layer.forward if isinstance(layer, nn.Module) else layer
            if lengths is not None and lengths_arg_exists(fn):
                x = layer(x, lengths=lengths)
            else:
                x = layer(x)
            if isinstance(x, tuple):
                x, lengths = x
                new_lengths = True
        return (x, lengths) if new_lengths else x


class ModuleList(_Chain):
    """Hold modules; called, apply each in order with the same extra
    arguments."""

    def forward(self, x, *args, **kwargs):
        for layer in self.layers:
            x = layer(x, *args, **kwargs)
        return x


class ConnectBlocks(nn.Module):
    """Blocks in sequence with shortcut connections between them.

    Arguments
    ---------
    blocks : list of modules or callables
    shortcut_type : "residual" | "dense" | "skip"
        ``"residual"`` and ``"dense"`` add each block's input to its
        output (the JAX package's ``"dense"`` shortcut is its input too);
        ``"skip"`` chains the blocks and sums their outputs where their
        shapes agree (a block of another shape starts the sum afresh).
    shortcut_projection : bool
        Project a shortcut whose width differs from the block's output
        with a ``Linear``. The widths are known at the first call, so the
        projections are made then (as flax makes them at ``init``).
    combine_fn : "add" | "avg"
    """

    def __init__(self, blocks, shortcut_type="residual",
                 shortcut_projection=False, combine_fn="add",
                 device="cuda", dtype=None, generator=None):
        super().__init__()
        if shortcut_type not in ("residual", "dense", "skip"):
            raise ValueError("shortcut_type must be residual/dense/skip")
        self.blocks = _Chain(blocks)
        self.shortcut_type = shortcut_type
        self.shortcut_projection = shortcut_projection
        self.combine_fn = combine_fn
        self.projections = nn.ModuleDict()
        self._kw = dict(device=device, generator=generator)
        if dtype is not None:
            self._kw["dtype"] = dtype

    def _project(self, i, shortcut, width):
        key = f"proj_{i}"
        if key not in self.projections:
            self.projections[key] = Linear(width, shortcut.shape[-1],
                                           **self._kw)
        return self.projections[key](shortcut)

    def forward(self, x):
        outputs = []
        for i, block in enumerate(self.blocks.layers):
            y = block(x)
            if self.shortcut_type == "skip":
                outputs.append(y)
                x = y
                continue
            shortcut = x
            if self.shortcut_projection and shortcut.shape[-1] != y.shape[-1]:
                shortcut = self._project(i, shortcut, y.shape[-1])
            x = (y + shortcut) / 2.0 if self.combine_fn == "avg" \
                else y + shortcut
        if self.shortcut_type == "skip":
            out = outputs[0]
            for o in outputs[1:]:
                out = out + o if out.shape == o.shape else o
            return out
        return x
