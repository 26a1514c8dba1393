"""The hand-written kernels' wrappers, and the check they share."""

import torch


def refuse_autograd(plain_name, *tensors):
    """Raise ``ValueError`` if autograd would have to pass through a
    kernel: grad mode is on and a floating tensor among ``tensors``
    requires grad. No kernel here has a backward, and a result cut off
    from the graph would stop the gradient without a word; the caller is
    pointed at the plain version, which builds a graph. Each wrapper's
    CUDA arm calls this before any other check."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.requires_grad):
            raise ValueError(
                f"this kernel has no backward and an input requires grad: "
                f"call {plain_name} to differentiate through it, or run "
                f"under torch.no_grad()"
            )
