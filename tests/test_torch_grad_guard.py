"""No kernel has a backward, so no wrapper's CUDA arm may hand back a
result cut off from the autograd graph: with grad mode on and a floating
input that requires grad, each raises ``ValueError`` naming the plain
version, before any device check. Here on the CPU the CUDA arms are
called directly with CPU tensors: the guard's error must come first; under
``torch.no_grad()`` the call gets past it to the device check. The plain
versions, which the wrappers take for CPU tensors, carry gradients.

(``tests/test_torch_cuda_kernels.py`` holds the same guard on the card,
through the public wrappers.)"""

import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch

from speechbrain_tpu_torch.ops import (
    attention,
    beam_attention,
    gather,
    mel_frontend,
)


def _fbank_args(grad):
    window = torch.hann_window(400)
    cos_m, sin_m = mel_frontend.dft_tables(window, 400)
    fb = torch.rand(201, 8)
    wav = torch.randn(2, 1600, requires_grad=grad)
    return (wav, cos_m, sin_m, fb, 400, 160, 10.0, 1e-10, 0.0)


def _ancestry_args(grad):
    q = torch.randn(1, 2, 2, 32, requires_grad=grad)
    k = torch.randn(1, 2, 4, 64)
    v = torch.randn(1, 2, 4, 64)
    anc = torch.zeros(1, 2, 4, dtype=torch.int32)
    return (q, k, v, anc, 1)


def _flash_args(grad):
    q = torch.randn(1, 2, 5, 32)
    k = torch.randn(1, 2, 5, 32, requires_grad=grad)
    return (q, k, torch.randn(1, 2, 5, 32))


def _gather_args(grad):
    return (torch.randn(4, 3, requires_grad=grad), torch.tensor([2, 0]))


# kernel: (module, CUDA arm, plain version, inputs, the device error)
CASES = {
    "fused_fbank": (mel_frontend, "_fused_fbank_cuda",
                    "fused_fbank_reference", _fbank_args, "CUDA device"),
    "ancestry_attention": (beam_attention, "_ancestry_attention_cuda",
                           "ancestry_attention_reference", _ancestry_args,
                           "CUDA tensor"),
    "flash_attention": (attention, "_flash_attention_cuda",
                        "flash_attention_reference", _flash_args, "CUDA"),
    "row_gather": (gather, "_row_gather_cuda", "row_gather_reference",
                   _gather_args, "CUDA tensors"),
}


@pytest.mark.parametrize("kernel", list(CASES))
def test_cuda_arm_refuses_inputs_that_require_grad(kernel):
    module, arm, plain, args, _ = CASES[kernel]
    launches = module.launches
    with pytest.raises(ValueError, match=plain):
        getattr(module, arm)(*args(True))
    assert module.launches == launches


@pytest.mark.parametrize("kernel", list(CASES))
def test_guard_lets_no_grad_calls_through(kernel):
    module, arm, plain, args, device_error = CASES[kernel]
    with torch.no_grad(), pytest.raises(ValueError) as err:
        getattr(module, arm)(*args(True))
    assert plain not in str(err.value)
    assert device_error in str(err.value)


@pytest.mark.parametrize("kernel", list(CASES))
def test_plain_versions_carry_gradients(kernel):
    module, _, plain, args, _ = CASES[kernel]
    inputs = args(True)
    if kernel == "fused_fbank":
        inputs = inputs[:3] + (torch.rand(201, 8),) + inputs[4:]
    out = getattr(module, plain)(*inputs)
    if isinstance(out, tuple):
        out = out[0]
    out.float().sum().backward()
    grads = [t.grad for t in inputs
             if isinstance(t, torch.Tensor) and t.requires_grad]
    assert grads and all(g is not None and torch.isfinite(g).all()
                         for g in grads)
