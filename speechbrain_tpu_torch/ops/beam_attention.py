"""Ancestry beam attention: beam-search KV attention WITHOUT cache permutes
(port of ``speechbrain_tpu/ops/beam_attention.py``).

Classic batched beam search reorders every per-hypothesis KV cache by the
predecessor index after each step. Here cache rows never move: at step
``s`` beam row ``h`` writes its new K/V into row ``h`` at position ``s``,
and a per-hypothesis ancestry table ``anc[b, h, t]`` records which row of
utterance ``b`` holds position ``t`` of hypothesis ``h``'s history.
Maintaining it costs one small int32 gather per step.

Attention through the indirection is a hand-written CUDA kernel
(``csrc/beam_attention.cu``): a block owns one (utterance, hypothesis,
head), stages its ancestry entries in shared memory with one coalesced load,
then gathers each K/V row directly, the loads of many positions in flight at
once. Head dims 32, 64 and 128 have a fast instantiation each; every other
head dim up to ``MAX_HEAD_DIM`` goes to a general one that reads the rows in
the widest vectors that divide them.
``ancestry_attention_reference`` is the plain PyTorch version of the same
function; the wrapper takes it only for tensors that lie on the CPU.
"""

import math

import torch

from speechbrain_tpu_torch.ops import refuse_autograd
from speechbrain_tpu_torch.ops._build import load_library

NEG_INF = -1e30

# head dims with a fast instantiation of the CUDA kernel; every other head
# dim up to MAX_HEAD_DIM takes the general one (the JAX kernel takes any)
KERNEL_HEAD_DIMS = (32, 64, 128)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# number of kernel launches made by this process (the plain version does
# not count); ``chip_smoke.py`` zeroes and reads it
launches = 0

# How the kernel walks a history, for the checks that aim at its seams: it
# stages the ancestry entries ANCESTRY_CHUNK at a time, and loads the K/V
# rows of kernel_batch_positions(hd, dtype) positions a batch.
ANCESTRY_CHUNK = 1024
# positions a batch of the general instantiation: four warps, a position a
# warp, four positions a warp
GENERAL_BATCH_POSITIONS = 16


def kernel_batch_positions(hd, dtype):
    """Positions in one batch of the kernel's K/V loads. The fast head
    dims: a block of 128 threads, ``hd * itemsize / 16`` lanes a position,
    four positions a lane group. Any other: ``GENERAL_BATCH_POSITIONS``."""
    if hd not in KERNEL_HEAD_DIMS:
        return GENERAL_BATCH_POSITIONS
    lanes = hd * (torch.finfo(dtype).bits // 8) // 16
    return 128 // lanes * 4


def ancestry_attention_reference(q, k_cache, v_cache, anc, step):
    """Plain PyTorch version: gather, then attend.

    Arguments
    ---------
    q : (B, K, H, hd) queries of the current step (one per hypothesis).
    k_cache, v_cache : (B, K, L, D) with D = H*hd; row-static KV caches.
    anc : (B, K, L) int32 ancestry table (values in [0, K)).
    step : int; positions 0..step (inclusive) attend.

    Returns
    -------
    out : (B, K, D) attention outputs (dtype of q).
    """
    B, K, L, D = k_cache.shape
    H, hd = q.shape[2], q.shape[3]
    idx = anc.long()[..., None].expand(B, K, L, D)
    k_g = torch.gather(k_cache, 1, idx)
    v_g = torch.gather(v_cache, 1, idx)
    qh = q.float() * (1.0 / math.sqrt(hd))
    # (B, K, L, H): multiply broadcast over L, reduce hd
    scores = torch.sum(
        qh[:, :, None] * k_g.reshape(B, K, L, H, hd).float(), dim=-1
    )
    valid = (torch.arange(L, device=q.device) <= step)[None, None, :, None]
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=2)
    out = torch.sum(
        w[..., None] * v_g.reshape(B, K, L, H, hd).float(), dim=2
    )  # (B, K, H, hd)
    return out.reshape(B, K, D).to(q.dtype)


def _check(name, t, shape, dtype):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, not {shape}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, not {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _ancestry_attention_cuda(q, k_cache, v_cache, anc, step):
    """Launch ``csrc/beam_attention.cu`` on PyTorch's current stream."""
    global launches
    refuse_autograd("ancestry_attention_reference", q, k_cache, v_cache)
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError("q must be (B, K, H, hd), caches (B, K, L, D)")
    B, K, L, D = k_cache.shape
    H, hd = q.shape[2], q.shape[3]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the ancestry attention kernel takes float32 and bfloat16, "
            f"not {q.dtype}"
        )
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"the ancestry attention kernel takes head dims 1 to "
            f"{MAX_HEAD_DIM}, not {hd}"
        )
    if H * hd != D:
        raise ValueError(f"cache width {D} is not H*hd = {H}*{hd}")
    step = int(step)
    if not 0 <= step < L:
        raise ValueError(f"step {step} outside the cache length {L}")
    _check("q", q, (B, K, H, hd), q.dtype)
    _check("k_cache", k_cache, (B, K, L, D), q.dtype)
    _check("v_cache", v_cache, (B, K, L, D), q.dtype)
    _check("anc", anc, (B, K, L), torch.int32)
    if not (q.device == k_cache.device == v_cache.device == anc.device):
        raise ValueError("all tensors must lie on the same device")
    lib = load_library()
    out = torch.empty((B, K, D), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        err = lib.sb_ancestry_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            anc.data_ptr(), out.data_ptr(), B, K, L, H, hd, step,
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ancestry attention kernel launch failed (code {err})"
        )
    launches += 1
    return out


def ancestry_attention(q, k_cache, v_cache, anc, step):
    """Beam attention through the ancestry indirection (see module doc).

    A CUDA tensor goes to the hand-written kernel, or the call raises; a
    CPU tensor goes to :func:`ancestry_attention_reference`.
    """
    if q.is_cuda:
        return _ancestry_attention_cuda(q, k_cache, v_cache, anc, step)
    return ancestry_attention_reference(q, k_cache, v_cache, anc, step)
