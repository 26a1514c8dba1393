"""Flash attention (port of ``speechbrain_tpu/ops/attention.py``).

``softmax(q kᵀ / sqrt(D) + bias) v`` with an online softmax, as one
hand-written CUDA kernel (``csrc/flash_attention.cu``): the ``(Tq, Tk)``
scores never reach device memory and the attention weights are not
returned. ``flash_attention_reference`` is the plain PyTorch version of the
same function (scores materialised, then softmax, all in float32); the
wrapper takes it only for tensors that lie on the CPU.

The kernel reads ``q``, ``k``, ``v`` through their strides (unit stride
along D), so the head-major views that ``MultiheadAttention._heads`` makes
go in without a copy, and takes any additive bias broadcastable to
``(B, H, Tq, Tk)`` through its own strides — among them the
``(B, 1, 1, Tk)`` key-padding and ``(1, 1, Tq, Tk)`` causal forms of
``make_mask_bias``, which the JAX kernel could not take.
"""

import ctypes
import math

import torch

from speechbrain_tpu_torch.ops import refuse_autograd
from speechbrain_tpu_torch.ops._build import load_library

# head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# number of kernel launches made by this process (the plain version does
# not count); ``chip_smoke.py`` zeroes and reads it
launches = 0


def flash_attention_reference(q, k, v, bias=None):
    """Plain PyTorch version, in float32 throughout.

    Arguments
    ---------
    q : (B, H, Tq, D) queries.
    k, v : (B, H, Tk, D) keys and values.
    bias : None, or an additive bias broadcastable to (B, H, Tq, Tk).

    Returns
    -------
    out : (B, H, Tq, D) in the dtype of ``q``.
    """
    qs = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.matmul(qs, k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


def _check_operand(name, t, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, not {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride along its last axis")
    row_strides = [t.stride(i) for i in range(3) if t.shape[i] > 1]
    if t.data_ptr() % 16 or any(
        s * t.element_size() % 16 for s in row_strides
    ):
        raise ValueError(f"{name} must have 16-byte aligned rows")


def _flash_attention_cuda(q, k, v, bias=None):
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream."""
    global launches
    refuse_autograd("flash_attention_reference", q, k, v, bias)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, H, Tq, D), k and v (B, H, Tk, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the flash attention kernel takes float32 and bfloat16, "
            f"not {q.dtype}"
        )
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the flash attention kernel takes head dims "
            f"{KERNEL_HEAD_DIMS}, not {D}"
        )
    _check_operand("q", q, (B, H, Tq, D), q.dtype, q.device)
    _check_operand("k", k, (B, H, Tk, D), q.dtype, q.device)
    _check_operand("v", v, (B, H, Tk, D), q.dtype, q.device)
    if min(B, H, Tq, Tk) == 0:
        raise ValueError("flash attention needs at least one query and key")
    bias_ptr, bias_code, bias_strides = None, 0, (0, 0, 0)
    if bias is not None:
        if not bias.is_cuda or bias.device != q.device:
            raise ValueError(f"bias must be a CUDA tensor on {q.device}")
        if bias.dtype not in (torch.float32, q.dtype):
            raise ValueError(
                f"bias must be float32 or {q.dtype}, not {bias.dtype}"
            )
        try:
            bias = bias.expand(B, H, Tq, Tk)
        except RuntimeError as e:
            raise ValueError(
                f"bias of shape {tuple(bias.shape)} does not broadcast to "
                f"{(B, H, Tq, Tk)}"
            ) from e
        if Tk > 1 and bias.stride(3) != 1:
            raise ValueError("bias must have unit stride along Tk")
        bias_ptr = bias.data_ptr()
        bias_code = _DTYPE_CODES[bias.dtype]
        bias_strides = bias.stride()[:3]
    # same strides as q where q is dense: for the views of
    # MultiheadAttention._heads the merge back to (B, T, H*D) is then free
    out = torch.empty_like(q)
    _check_operand("out", out, (B, H, Tq, D), q.dtype, q.device)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *bias_strides,
        *out.stride()[:3],
    )
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.sb_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), B, H, Tq, Tk, D, strides, _DTYPE_CODES[q.dtype],
            bias_code, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (code {err})")
    launches += 1
    return out


def flash_attention(q, k, v, bias=None):
    """``softmax(q kᵀ / sqrt(D) + bias) v``; returns ``(out, None)``, as the
    JAX function does (the weights are not materialised).

    A CUDA tensor goes to the hand-written kernel, or the call raises; a
    CPU tensor goes to :func:`flash_attention_reference`.

    Example
    -------
    >>> q = torch.ones(1, 2, 5, 32)
    >>> out, w = flash_attention(q, q, q)
    >>> out.shape, w
    (torch.Size([1, 2, 5, 32]), None)
    """
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, bias), None
    return flash_attention_reference(q, k, v, bias), None
