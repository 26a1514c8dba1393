"""Mixed precision (port of ``speechbrain_tpu/utils/autocast.py``).

The JAX package casts a batch's float inputs to bfloat16 at the step's
boundary. Here ``precision="bf16"`` is ``torch.autocast`` with bfloat16
around the forward pass, parameters kept in float32: autocast chooses
the type per operation, and inputs keep theirs (the waveform stays
float32, which the fused log-mel kernel needs). Numerically sensitive
parts opt out with :func:`fwd_default_precision`.
"""

import contextlib
import functools

import torch

_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32, None: torch.float32,
    "fp16": torch.float16, "float16": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def autocast(precision, device):
    """A context that runs its body at ``precision`` on ``device``:
    ``torch.autocast`` for a 16-bit type, nothing for float32.

    Example
    -------
    >>> with autocast("bf16", torch.device("cpu")):
    ...     (torch.ones(2, 2) @ torch.ones(2, 2)).dtype
    torch.bfloat16
    """
    if precision not in _DTYPES:
        raise ValueError(f"unknown precision {precision!r}")
    dtype = _DTYPES[precision]
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type, dtype=dtype)


def cast_floats(obj, dtype):
    """Cast every floating tensor in nested lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: cast_floats(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast_floats(v, dtype) for v in obj)
    return obj


def fwd_default_precision(fwd=None, cast_inputs=torch.float32):
    """Decorator: run ``fwd`` with autocast off and its floating inputs
    cast to ``cast_inputs``, so that a sensitive part (features,
    normalisation statistics) stays in float32 inside a bf16 forward.
    ``force_allow_autocast=True`` at the call lets autocast through.

    Example
    -------
    >>> @fwd_default_precision
    ... def f(x):
    ...     return (x @ x).dtype
    >>> with torch.autocast("cpu", torch.bfloat16):
    ...     f(torch.ones(2, 2))
    torch.float32
    """
    if fwd is None:
        return functools.partial(fwd_default_precision,
                                 cast_inputs=cast_inputs)

    @functools.wraps(fwd)
    def wrapper(*args, force_allow_autocast=False, **kwargs):
        if force_allow_autocast:
            return fwd(*args, **kwargs)
        args = cast_floats(args, cast_inputs)
        kwargs = cast_floats(kwargs, cast_inputs)
        with contextlib.ExitStack() as stack:
            for device_type in ("cuda", "cpu"):
                if torch.is_autocast_enabled(device_type):
                    stack.enter_context(
                        torch.autocast(device_type=device_type,
                                       enabled=False)
                    )
            return fwd(*args, **kwargs)

    return wrapper
