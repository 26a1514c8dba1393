"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests need an NVIDIA GPU and ``nvcc``; where there is no
CUDA device they skip. Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

(``python3 chip_smoke.py`` makes the same comparisons at the main path's
full shapes.)"""

import numpy as np
import pytest
import torch

from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.ops import beam_attention, mel_frontend

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_ancestry_attention_kernel_matches_plain(card, dtype, atol, hd):
    rng = np.random.default_rng(hd)
    B, K, H, L = 2, 5, 3, 45
    q = torch.from_numpy(
        rng.standard_normal((B, K, H, hd)).astype(np.float32)
    ).to(card, dtype)
    k, v = (
        torch.from_numpy(
            rng.standard_normal((B, K, L, H * hd)).astype(np.float32)
        ).to(card, dtype)
        for _ in range(2)
    )
    anc = torch.from_numpy(
        rng.integers(0, K, (B, K, L)).astype(np.int32)
    ).to(card)
    before = beam_attention.launches
    for step in (0, 1, 31, 44):
        out = beam_attention.ancestry_attention(q, k, v, anc, step)
        ref = beam_attention.ancestry_attention_reference(q, k, v, anc, step)
        assert out.dtype == dtype
        assert float((out.float() - ref.float()).abs().max()) <= atol
    assert beam_attention.launches == before + 4


def test_ancestry_attention_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 2, 48, device=card)
    kv = torch.zeros(1, 2, 8, 96, device=card)
    anc = torch.zeros(1, 2, 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head dims"):
        beam_attention.ancestry_attention(q, kv, kv, anc, 0)
    q = torch.zeros(1, 2, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        beam_attention.ancestry_attention(q, kv, kv, anc, 0)
    q = torch.zeros(1, 2, 2, 64, device=card)
    kv = torch.zeros(1, 2, 8, 128, device=card)
    with pytest.raises(ValueError, match="int32"):
        beam_attention.ancestry_attention(q, kv, kv, anc.long(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        beam_attention.ancestry_attention(
            q, kv.transpose(1, 2).contiguous().transpose(1, 2), kv, anc, 0
        )


@pytest.mark.parametrize("hop_ms", [10, 8, 16])
def test_fused_fbank_kernel_matches_plain_and_unfused(card, hop_ms):
    wav = torch.from_numpy(
        np.random.default_rng(hop_ms).standard_normal((3, 20000)).astype(
            np.float32
        )
    ).to(card)
    fused = Fbank(n_mels=80, hop_length=hop_ms, fused=True, device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = mel_frontend.fused_fbank_reference(
        wav, *fused._tables, fused.compute_fbanks.fbank_matrix,
        fused.compute_STFT.n_fft, fused.compute_STFT.hop_length, 10.0, 1e-10,
        0.0,
    )
    plain = torch.maximum(plain, plain.amax(dim=(1, 2), keepdim=True) - 80.0)
    unfused = Fbank(n_mels=80, hop_length=hop_ms, device=card)(wav)
    assert out.shape == unfused.shape
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3
