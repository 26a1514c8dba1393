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
from speechbrain_tpu_torch.nnet.attention import NEG_INF, MultiheadAttention
from speechbrain_tpu_torch.ops import (
    attention,
    beam_attention,
    gather,
    mel_frontend,
)
from speechbrain_tpu_torch.utils.signals import make_check_signal

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ancestry_case(case, hd, dtype):
    """(B, K, H, L) and the steps of one case: a small cache; the seams of
    the kernel's batches of positions in a cache (100) that is not a
    multiple of one; a history past one chunk of staged ancestry entries;
    the published decode's beam 66 over 288 positions."""
    if case == "small":
        return (2, 5, 3, 45), (0, 1, 31, 44)
    if case == "seams":
        P = beam_attention.kernel_batch_positions(hd, dtype)
        steps = sorted({s for i in (1, 2, 3) for s in (i * P - 1, i * P,
                                                      i * P + 1) if s < 100})
        return (2, 5, 3, 100), (*steps, 99)
    if case == "long_history":
        c = beam_attention.ANCESTRY_CHUNK
        return (1, 2, 1, c + 76), (c - 1, c, c + 1, c + 75)
    return (8, 66, 12, 288), (0, 143, 287)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd", [18, 32, 36, 48, 64, 128])
@pytest.mark.parametrize("case", ["small", "seams", "long_history",
                                  "beam66"])
def test_ancestry_attention_kernel_matches_plain(card, dtype, atol, hd, case):
    rng = np.random.default_rng(hd)
    (B, K, H, L), steps = _ancestry_case(case, hd, dtype)
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
    for step in steps:
        out = beam_attention.ancestry_attention(q, k, v, anc, step)
        ref = beam_attention.ancestry_attention_reference(q, k, v, anc, step)
        assert out.dtype == dtype
        assert float((out.float() - ref.float()).abs().max()) <= atol
    assert beam_attention.launches == before + len(steps)


def test_ancestry_attention_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 2, 320, device=card)
    kv = torch.zeros(1, 2, 8, 640, device=card)
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


def _plain_fbank(wav, fused, hop):
    """B3's plain version with the top_db clamp, at ``fused``'s tables."""
    plain = mel_frontend.fused_fbank_reference(
        wav, *fused._tables, fused.compute_fbanks.fbank_matrix,
        fused.compute_STFT.n_fft, hop, 10.0, 1e-10, 0.0,
    )
    return torch.maximum(plain, plain.amax(dim=(1, 2), keepdim=True) - 80.0)


# (signal, batch, samples, hop ms, n_fft): white noise at three hops; the
# two signals that show a DFT scheme's precision; frame counts at the seams
# of the kernel's 64-frame tiles (1, 63, 64, 65, 129 at hop 160; the first
# also shorter than n_fft / 2); n_fft 512
_FBANK_CASES = {
    "noise_hop10": ("noise", 3, 20000, 10, 400),
    "noise_hop8": ("noise", 3, 20000, 8, 400),
    "noise_hop16": ("noise", 3, 20000, 16, 400),
    "chirp": ("chirp", 2, 32000, 10, 400),
    "bursts": ("bursts", 2, 32000, 10, 400),
    "frames1_short": ("noise", 2, 100, 10, 400),
    "frames63": ("noise", 2, 62 * 160, 10, 400),
    "frames64": ("noise", 2, 63 * 160, 10, 400),
    "frames65": ("noise", 2, 64 * 160, 10, 400),
    "frames129": ("noise", 2, 128 * 160 + 7, 10, 400),
    "nfft512": ("bursts", 2, 32000, 10, 512),
    # the transducer recipe's training batch: 8 utterances of 8-12 s padded
    # to whole seconds, the longest
    "transducer_batch": ("noise", 8, 12 * 16000, 10, 400),
    # a streamed chunk of 0.96 s after StreamingFeatureWrapper's 640
    # samples of context: NORTH's batch, and one file
    "streaming_batch": ("noise", 8, 15360 + 640, 10, 400),
    "streaming_file": ("bursts", 1, 15360 + 640, 10, 400),
}


@pytest.mark.parametrize("case", list(_FBANK_CASES))
def test_fused_fbank_kernel_matches_plain_and_unfused(card, case):
    kind, batch, samples, hop_ms, n_fft = _FBANK_CASES[case]
    wav = torch.from_numpy(
        make_check_signal(kind, batch, samples, seed=hop_ms)
    ).to(card)
    fused = Fbank(n_mels=80, hop_length=hop_ms, n_fft=n_fft, fused=True,
                  device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    unfused = Fbank(n_mels=80, hop_length=hop_ms, n_fft=n_fft,
                    device=card)(wav)
    assert out.shape == unfused.shape
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3


def test_streaming_wrapper_launches_b3_a_chunk(card, monkeypatch):
    """``StreamingFeatureWrapper(Fbank(fused=True))`` over four chunks of
    a strided batch view: B3 once a chunk, and the frames within 5e-3 dB
    of the same wrapper over B3's plain version."""
    from speechbrain_tpu_torch.lobes.features import StreamingFeatureWrapper

    wav = torch.from_numpy(
        make_check_signal("noise", 8, 4 * 15360, seed=3)).to(card)
    fused = Fbank(n_mels=80, fused=True, device=card)
    streams = {}
    for arm in ("kernel", "plain"):
        if arm == "plain":
            monkeypatch.setattr(
                mel_frontend, "_fused_fbank_cuda",
                lambda *args, operands=None:
                mel_frontend.fused_fbank_reference(*args))
        wrapper = StreamingFeatureWrapper(fused)
        ctx = wrapper.make_streaming_context(8)
        before, out = mel_frontend.launches, []
        for c in range(4):
            feats, ctx = wrapper(wav[:, c * 15360:(c + 1) * 15360], ctx)
            out.append(feats)
        assert mel_frontend.launches == before + (4 if arm == "kernel"
                                                  else 0)
        streams[arm] = torch.cat(out, dim=1)
    assert streams["kernel"].shape == (8, 4 * 96, 80)
    assert float((streams["kernel"] - streams["plain"]).abs().max()) <= 5e-3


@pytest.mark.parametrize("case", ["noise_hop10", "chirp", "bursts",
                                  "frames65", "frames129"])
def test_fused_fbank_kernel_at_40_mels(card, case):
    """The CRDNN recipe's front end: n_fft 400 and 40 mel filters, whose
    widest filter spans about twice the bins of the 80-filter bank's."""
    kind, batch, samples, hop_ms, n_fft = _FBANK_CASES[case]
    wav = torch.from_numpy(
        make_check_signal(kind, batch, samples, seed=hop_ms + 40)
    ).to(card)
    fused = Fbank(n_mels=40, hop_length=hop_ms, n_fft=n_fft, fused=True,
                  device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    unfused = Fbank(n_mels=40, hop_length=hop_ms, n_fft=n_fft,
                    device=card)(wav)
    assert out.shape == unfused.shape == plain.shape
    assert out.shape[-1] == 40
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3


# the MTL perceptual pre-training's batch: 4 utterances of 4 s at 40 mels,
# unpadded and as the loader pads them (to a multiple of 2048 samples)
_GAN_FBANK_CASES = {
    "noise_64000": ("noise", 4, 64000),
    "chirp_64000": ("chirp", 4, 64000),
    "bursts_65536": ("bursts", 4, 65536),
}


@pytest.mark.parametrize("case", list(_GAN_FBANK_CASES))
def test_fused_fbank_kernel_at_the_mtl_pretraining_batch(card, case):
    """``pretrain_perceptual.yaml``'s fused Fbank (40 mels, n_fft 400):
    one launch, within 5e-3 dB of the plain version and of the unfused
    Fbank."""
    kind, batch, samples = _GAN_FBANK_CASES[case]
    wav = torch.from_numpy(
        make_check_signal(kind, batch, samples, seed=17)).to(card)
    fused = Fbank(n_mels=40, fused=True, device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    unfused = Fbank(n_mels=40, device=card)(wav)
    assert out.shape == unfused.shape == plain.shape == (
        batch, 1 + samples // fused.compute_STFT.hop_length, 40)
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3


# the speaker family's two configurations: speech commands' 24 mels at
# (16, 16000) and VoxCeleb's 3 s crops at (32, 48000), 80 mels
_SPEAKER_FBANK_CASES = {
    "24_mels_noise": ("noise", 16, 16000, 24),
    "24_mels_chirp": ("chirp", 16, 16000, 24),
    "24_mels_bursts": ("bursts", 16, 16000, 24),
    "80_mels_voxceleb_crops": ("noise", 32, 48000, 80),
}


@pytest.mark.parametrize("case", list(_SPEAKER_FBANK_CASES))
def test_fused_fbank_kernel_at_the_speaker_configurations(card, case):
    """24 mel filters (the widest filters of the banks in use: each spans
    about three times the bins of the 80-filter bank's) and the VoxCeleb
    crops' batch: one launch, within 5e-3 dB of the plain version and of
    the unfused Fbank."""
    kind, batch, samples, n_mels = _SPEAKER_FBANK_CASES[case]
    wav = torch.from_numpy(
        make_check_signal(kind, batch, samples, seed=n_mels)).to(card)
    fused = Fbank(n_mels=n_mels, fused=True, device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    unfused = Fbank(n_mels=n_mels, device=card)(wav)
    assert out.shape == unfused.shape == plain.shape
    assert out.shape[-1] == n_mels
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3


# the audio classifiers' batches: ESC50's 5 s clips at (8, 80000) and
# UrbanSound8k's 4 s at (8, 64000), 80 mels
_CLASSIFY_FBANK_CASES = {
    "esc50_noise": ("noise", 8, 80000),
    "esc50_chirp": ("chirp", 8, 80000),
    "urbansound8k_noise": ("noise", 8, 64000),
    "urbansound8k_bursts": ("bursts", 8, 64000),
}


@pytest.mark.parametrize("case", list(_CLASSIFY_FBANK_CASES))
def test_fused_fbank_kernel_at_the_classifier_batches(card, case):
    """One launch at each batch, within 5e-3 dB of the plain version and
    of the unfused Fbank."""
    _one_launch_within_5e_3_db(card, *_CLASSIFY_FBANK_CASES[case])


def _one_launch_within_5e_3_db(card, kind, batch, samples):
    wav = torch.from_numpy(
        make_check_signal(kind, batch, samples, seed=5)).to(card)
    fused = Fbank(n_mels=80, fused=True, device=card)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    unfused = Fbank(n_mels=80, device=card)(wav)
    assert out.shape == unfused.shape == plain.shape
    assert out.shape[1] == 1 + samples // fused.compute_STFT.hop_length
    assert float((out - plain).abs().max()) <= 5e-3
    assert float((out - unfused).abs().max()) <= 5e-3


_BESTRQ_FBANK_CASES = {
    "bestrq_noise": ("noise", 8, 256000),
    "bestrq_chirp": ("chirp", 8, 256000),
    "bestrq_bursts": ("bursts", 8, 256000),
}


@pytest.mark.parametrize("case", list(_BESTRQ_FBANK_CASES))
def test_fused_fbank_kernel_at_the_bestrq_batch(card, case):
    """BEST-RQ's batches (8 utterances of 16 s, 80 mels): one launch,
    within 5e-3 dB of the plain version and of the unfused Fbank."""
    _one_launch_within_5e_3_db(card, *_BESTRQ_FBANK_CASES[case])


@pytest.mark.parametrize("kind", ["noise", "chirp"])
def test_fused_fbank_with_deltas_and_context(card, kind):
    """``Fbank(deltas=True, context=True, fused=True)``: one launch, and
    against the unfused Fbank the log-mels within 5e-3 dB, their deltas
    within 0.6 of it and the second deltas within 0.36 (a delta's weights
    sum to 6/10 in absolute value), in every context block."""
    wav = torch.from_numpy(make_check_signal(kind, 4, 48000, seed=7))
    wav = wav.to(card)
    kw = dict(n_mels=80, deltas=True, context=True, device=card)
    fused = Fbank(fused=True, **kw)
    before = mel_frontend.launches
    out = fused(wav)
    assert mel_frontend.launches == before + 1
    unfused = Fbank(**kw)(wav)
    assert out.shape == unfused.shape == (4, 301, 11 * 3 * 80)
    err = (out - unfused).abs().reshape(4, 301, 11, 3, 80)
    for i, bound in enumerate((5e-3, 3e-3, 1.8e-3)):
        assert float(err[..., i, :].max()) <= bound


@pytest.mark.parametrize("hop", [161, 100, 320, 441, 1000])
def test_fused_fbank_kernel_odd_and_long_hops(card, hop):
    """Through ``fused_fbank`` itself: hops that take the span's 4-byte
    copies and a skew other than 4 (161, 100), and hops whose span of 64
    frames does not fit a block beside the ring, so that a block takes 32
    (320, 441) or 16 (1000) frames."""
    wav = torch.from_numpy(make_check_signal("chirp", 3, 30001, seed=hop))
    wav = wav.to(card)
    fused = Fbank(n_mels=80, fused=True, device=card)
    out = mel_frontend.fused_fbank(
        wav, fused.compute_STFT.window, fused.compute_fbanks.fbank_matrix,
        n_fft=400, hop_length=hop, tables=fused._tables,
        operands=fused._operands,
    )
    assert out.shape == (3, 1 + 30001 // hop, 80)
    assert float((out - _plain_fbank(wav, fused, hop)).abs().max()) <= 5e-3


def test_fused_fbank_kernel_keeps_a_nan_as_its_plain_version(card):
    """A NaN waveform gives NaN features, as the plain version's clamp
    gives them, so that a training step sees a loss that is not finite;
    the other rows stay finite and equal to the plain version's."""
    wav = torch.from_numpy(make_check_signal("noise", 3, 16000, seed=4))
    wav = wav.to(card)
    wav[1] = float("nan")
    wav[2, 5000] = float("nan")
    fused = Fbank(n_mels=80, fused=True, device=card)
    out = fused(wav)
    plain = _plain_fbank(wav, fused, fused.compute_STFT.hop_length)
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert bool(torch.isnan(out[1]).all()) and bool(torch.isnan(out[2]).all())
    assert float((out[0] - plain[0]).abs().max()) <= 5e-3


def test_fused_fbank_kernel_raises_on_what_it_does_not_take(card):
    fused = Fbank(n_mels=80, fused=True, device=card)
    window = fused.compute_STFT.window
    fb = fused.compute_fbanks.fbank_matrix
    wav = torch.zeros(2, 16000, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        mel_frontend.fused_fbank(wav[:, ::2], window, fb)
    with pytest.raises(ValueError, match="shared memory"):
        # 1024 filters over every bin: their weights alone pass 227 KB
        mel_frontend.fused_fbank(
            wav, window, torch.ones(fb.shape[0], 1024, device=card)
        )
    with pytest.raises(ValueError, match="operands"):
        mel_frontend.fused_fbank(
            wav, window, fb, operands=fused._operands._replace(
                mel_weights=fused._operands.mel_weights.double()
            ),
        )


def _flash_bias(form, B, H, Tq, Tk, dtype, card, rng, mask_all=False):
    """The bias of one form; with ``mask_all`` every key of one query row
    (for "key_padding": of batch 0) is masked by NEG_INF."""
    if form == "none" and mask_all:
        b = np.zeros((B, H, Tq, Tk))
    elif form == "none":
        return None
    elif form == "tq_tk":
        b = rng.standard_normal((Tq, Tk))
    elif form == "full":
        b = rng.standard_normal((B, H, Tq, Tk))
    elif form == "key_padding":  # (B, 1, 1, Tk), the last keys of batch 1
        b = np.zeros((B, 1, 1, Tk))
        b[1, ..., Tk - Tk // 3:] = NEG_INF
    else:  # "causal", (1, 1, Tq, Tk)
        b = np.triu(np.full((1, 1, Tq, Tk), NEG_INF), k=max(1, Tk - Tq + 1))
    if mask_all and form == "key_padding":
        b[0] = NEG_INF
    elif mask_all:
        b[(0,) * (b.ndim - 2) + (Tq // 2,)] = NEG_INF
    return torch.from_numpy(b.astype(np.float32)).to(card, dtype)


# (dtype, atol, Tq, Tk, mask_all): Tq != Tk and neither a multiple of a
# tile, with and without a fully masked row, in both types; and in bf16,
# every pair of lengths about the tensor-core kernel's 128-row query tile
# and its 64-key tiles
_EDGE_T = (1, 63, 64, 65, 127, 128, 129)
_FLASH_CASES = [
    (dtype, atol, 77, 130, mask_all)
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))
    for mask_all in (False, True)
] + [(torch.bfloat16, 2e-2, Tq, Tk, False) for Tq in _EDGE_T for Tk in _EDGE_T]


@pytest.mark.parametrize("dtype,atol,Tq,Tk,mask_all", _FLASH_CASES)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize(
    "form", ["none", "tq_tk", "full", "key_padding", "causal"]
)
def test_flash_attention_kernel_matches_plain(card, dtype, atol, Tq, Tk,
                                              mask_all, hd, form):
    """q, k, v are the strided head-major views that
    MultiheadAttention._heads makes. A fully masked row has equal scores
    (all -1e30), so the plain version gives the mean of V there."""
    rng = np.random.default_rng(hd + len(form))
    B, H = 2, 3

    def heads(T):
        x = torch.from_numpy(
            rng.standard_normal((B, T, H * hd)).astype(np.float32)
        ).to(card, dtype)
        return x.reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(Tq), heads(Tk), heads(Tk)
    assert Tq == 1 or not q.is_contiguous()  # a 1-row view is contiguous
    bias = _flash_bias(form, B, H, Tq, Tk, dtype, card, rng, mask_all)
    before = attention.launches
    out, w = attention.flash_attention(q, k, v, bias)
    assert attention.launches == before + 1 and w is None
    ref = attention.flash_attention_reference(q, k, v, bias)
    assert out.dtype == dtype and out.shape == (B, H, Tq, hd)
    assert float((out.float() - ref.float()).abs().max()) <= atol


def test_flash_attention_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head dims"):
        attention.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        attention.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(ValueError, match="unit stride"):
        attention.flash_attention(q, q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), q)
    with pytest.raises(ValueError, match="aligned"):
        attention.flash_attention(q[..., 1:33], q[..., 1:33], q[..., 1:33])
    with pytest.raises(ValueError, match="unit stride along Tk"):
        attention.flash_attention(q, q, q, torch.zeros(8, 8, device=card).t())
    with pytest.raises(ValueError, match="float32 or"):
        attention.flash_attention(
            q, q, q, torch.zeros(8, 8, device=card, dtype=torch.float16)
        )
    with pytest.raises(ValueError, match="float32 or"):  # fp32 q: fp32 bias
        attention.flash_attention(
            q, q, q, torch.zeros(8, 8, device=card, dtype=torch.bfloat16)
        )
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.flash_attention(q, q.cpu(), q)


def test_mha_use_pallas_launches_the_kernel(card):
    mha = MultiheadAttention(nhead=4, d_model=256, use_pallas=True,
                             device=card).eval()
    x = torch.randn(2, 70, 256, device=card)
    kpm = torch.zeros(2, 70, dtype=torch.bool, device=card)
    kpm[1, 50:] = True
    before = attention.launches
    with torch.no_grad():
        out, w = mha(x, x, x, key_padding_mask=kpm)
        mha.use_pallas = False
        ref, _ = mha(x, x, x, key_padding_mask=kpm)
    assert attention.launches == before + 1 and w is None
    assert float((out - ref).abs().max()) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(9,), (9, 40), (9, 5, 3), (9, 64, 512)])
def test_row_gather_kernel_is_bitwise_the_plain_copy(
    card, dtype, index_dtype, shape
):
    """Repeated indices, n_out != N, rows of 4..64K bytes (2-D fp32 (9, 5, 3)
    rows are 60 bytes: not a multiple of 16)."""
    x = torch.from_numpy(
        np.random.default_rng(len(shape)).standard_normal(shape).astype(
            np.float32
        )
    ).to(card, dtype)
    idx = torch.tensor([8, 0, 0, 3, 8, 1, 2, 2, 7, 4, 5], dtype=index_dtype,
                       device=card)
    before = gather.launches
    out = gather.row_gather(x, idx)
    assert gather.launches == before + 1
    assert torch.equal(out, gather.row_gather_reference(x, idx))


def test_row_gather_kernel_zero_fills_a_bad_index(card):
    x = torch.ones(4, 8, device=card)
    out = gather.row_gather(x, torch.tensor([1, 4, -1], device=card))
    torch.cuda.synchronize()
    assert out[0].eq(1).all() and out[1:].eq(0).all()


def test_row_gather_kernel_raises_on_what_it_does_not_take(card):
    x = torch.zeros(4, 8, device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather.row_gather(x, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="int32 or int64"):
        gather.row_gather(x, torch.tensor([0.0], device=card))
    with pytest.raises(ValueError, match="1-D"):
        gather.row_gather(x, torch.zeros(1, 1, dtype=torch.long, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        gather.row_gather(x.t(), torch.tensor([0], device=card))
    with pytest.raises(ValueError, match="aligned"):
        gather.row_gather(x.reshape(-1)[1:31].reshape(3, 10),
                          torch.tensor([0], device=card))


def _guard_cases(card):
    """kernel: (wrapper call taking ``requires_grad``, plain version)."""
    gen = torch.Generator(device=card).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=card)

    fbank = Fbank(n_mels=40, fused=True, device=card)
    cache = rand(1, 2, 8, 64)
    anc = torch.zeros(1, 2, 8, dtype=torch.int32, device=card)
    mha = MultiheadAttention(nhead=2, d_model=64, use_pallas=True,
                             device=card).train()
    return {
        "fused_fbank": (mel_frontend, "fused_fbank_reference",
                        lambda g: fbank(rand(2, 4000).requires_grad_(g))),
        "ancestry_attention": (
            beam_attention, "ancestry_attention_reference",
            lambda g: beam_attention.ancestry_attention(
                rand(1, 2, 2, 32).requires_grad_(g), cache, cache, anc, 3)),
        "flash_attention": (
            attention, "flash_attention_reference",
            lambda g: attention.flash_attention(
                rand(1, 2, 9, 32), rand(1, 2, 9, 32).requires_grad_(g),
                rand(1, 2, 9, 32))),
        "row_gather": (
            gather, "row_gather_reference",
            lambda g: gather.row_gather(rand(5, 16).requires_grad_(g),
                                        torch.tensor([4, 0], device=card))),
        "mha_use_pallas_training": (
            attention, "flash_attention_reference",
            lambda g: mha(*(rand(1, 9, 64).requires_grad_(g)
                            for _ in range(3)))),
    }


@pytest.mark.parametrize("case", ["fused_fbank", "ancestry_attention",
                                  "flash_attention", "row_gather",
                                  "mha_use_pallas_training"])
def test_wrappers_refuse_inputs_that_require_grad(card, case):
    """No kernel has a backward: a wrapper raises rather than return a
    result cut off from the graph, and launches nothing; under
    ``torch.no_grad()`` the same call launches its kernel once."""
    module, plain, call = _guard_cases(card)[case]
    before = module.launches
    with pytest.raises(ValueError, match=plain):
        call(True)
    assert module.launches == before
    with torch.no_grad():
        call(True)
    assert module.launches == before + 1


def test_fp32_training_step_through_fused_fbank_matches_plain(
        card, tmp_path, monkeypatch):
    """One float32 micro-batch of the recipe's Brain (``chip_smoke.ASR``)
    at a small size, through B3 and through its plain version, from the
    same weights: loss and gradients within ``chip_smoke``'s stated
    tolerances (TRAIN_FP32_*)."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dict(chip_smoke.TRAIN, vocab=30, n_mels=40, fe_channels=(8, 8),
               d_model=64, nhead=4, enc_layers=2, dec_layers=1, d_ffn=128,
               kernel_size=7, n_train=4, n_valid=1, seconds=(1.0, 2.0),
               n_tokens=(4, 8), batch_size=4, sig_multiple=16000)
    paths = chip_smoke.write_asr_corpus(cfg, str(tmp_path))
    ds = chip_smoke.asr_dataset(paths["train"], cfg, train=True)
    batch = next(iter(chip_smoke.make_train_loader(cfg, {"train": ds})))
    result = chip_smoke.train_step_kernel_vs_plain(cfg, batch, device=card)
    assert result["ok"], result


def test_sepformer_separation_serves_on_the_card_as_on_the_cpu(card):
    """A small SepFormer (no kernel of the port on its path) served by
    ``SepformerSeparation`` in float32 on the card and on the CPU, the
    same weights: the whole wrapper and the three modules equal on the
    card, the card within 1e-5 relative L2 of the CPU (TF32 off)."""
    from speechbrain_tpu_torch.inference.separation import (
        SepformerSeparation,
    )
    from speechbrain_tpu_torch.lobes.models.dual_path import SepformerWrapper

    torch.manual_seed(0)
    model = SepformerWrapper(
        encoder_kernel_size=16, encoder_out_nchannels=64,
        masknet_chunksize=50, masknet_numlayers=2, intra_numlayers=2,
        inter_numlayers=2, intra_nhead=4, inter_nhead=4, intra_dffn=128,
        inter_dffn=128, device="cpu")
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8000)).astype(np.float32))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        on_cpu = SepformerSeparation(modules={"masknet": model},
                                     run_opts={"device": "cpu"})
        ref = on_cpu.separate_batch(mix)
        whole = SepformerSeparation(modules={"masknet": model},
                                    run_opts={"device": "cuda"})
        out = whole.separate_batch(mix.to(card))
        parts = SepformerSeparation(
            modules={"encoder": model.encoder, "masknet": model.masknet,
                     "decoder": model.decoder}, run_opts={"device": "cuda"})
        assert torch.equal(parts.separate_batch(mix.to(card)), out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert out.shape == (2, 8000, 2) and out.device.type == "cuda"
    err = float((out.cpu() - ref).norm() / ref.norm())
    assert err <= 1e-5, err


@pytest.mark.parametrize("sr", [8000, 16000])
def test_istft_inverts_stft_on_the_card(card, sr):
    """``ISTFT(STFT(x))`` on the card at ``n_fft`` 512 with 32 ms windows:
    at 8 kHz the 256-sample window sits in the middle of the frame (C48's
    case), at 16 kHz it fills it; 1e-5 relative L2 both, and the card
    within 1e-5 of the CPU."""
    from speechbrain_tpu_torch.processing.features import STFT

    x = torch.from_numpy(np.random.default_rng(sr).standard_normal(
        (3, 2 * sr)).astype(np.float32))
    outs = {}
    for device in ("cpu", card):
        stft = STFT(sr, win_length=32, hop_length=16, n_fft=512,
                    device=device)
        outs[str(device)] = stft.inverse()(stft(x.to(device)),
                                           sig_length=x.shape[1]).cpu()
    err = float((outs["cuda"] - x).norm() / x.norm())
    assert err <= 1e-5, err
    assert float((outs["cuda"] - outs["cpu"]).norm() / x.norm()) <= 1e-5


def test_spectral_mask_step_on_the_card_as_on_the_cpu(card, tmp_path):
    """One float32 training step of the VoiceBank spectral-mask twin's
    ``EnhanceBrain`` over a small causal ``CNNTransformerSE`` (no kernel of
    the port on its path), on the card and on the CPU from the same
    weights and batch: the loss within 1e-5 relative, the weights after
    Adam's step within 1e-5 relative L2 (TF32 off)."""
    import copy

    from speechbrain_tpu_torch.dataio.batch import PaddedBatch
    from speechbrain_tpu_torch.lobes.models.transformer.TransformerSE import (
        CNNTransformerSE,
    )
    from speechbrain_tpu_torch.processing.features import STFT
    from speechbrain_tpu_torch.recipes.VoiceBank.enhance.spectral_mask.train import (  # noqa: E501
        EnhanceBrain,
    )

    torch.manual_seed(0)
    model = CNNTransformerSE(d_model=64, num_layers=2, nhead=4, d_ffn=128,
                             output_size=257, output_activation="sigmoid",
                             device="cpu")
    rng = np.random.default_rng(1)
    clean = 0.3 * rng.standard_normal((2, 16000)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((2, 16000)).astype(np.float32)
    batch = PaddedBatch([{"noisy_sig": torch.from_numpy(n),
                          "clean_sig": torch.from_numpy(c)}
                         for n, c in zip(noisy, clean)])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    try:
        for device in ("cpu", "cuda"):
            stft = STFT(16000, win_length=32, hop_length=16, n_fft=512,
                        device=device)
            brain = EnhanceBrain(
                modules={"model": copy.deepcopy(model)},
                opt_class=lambda p: torch.optim.Adam(p, lr=5e-4),
                hparams={"compute_stft": stft},
                run_opts={"device": device, "noprogressbar": True})
            brain.on_fit_start()
            brain.modules.train()
            brain.fit_batch(batch)
            loss = brain._flush_pending_loss()
            weights = torch.cat([p.detach().cpu().flatten()
                                 for p in brain.modules.parameters()])
            results[device] = (loss, weights)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (cpu_loss, cpu_w), (card_loss, card_w) = results["cpu"], \
        results["cuda"]
    assert np.isfinite(card_loss) and card_loss == pytest.approx(cpu_loss,
                                                                 rel=1e-5)
    assert float((card_w - cpu_w).norm() / cpu_w.norm()) <= 1e-5
    assert float((card_w - torch.cat([p.detach().flatten() for p in
                                      model.parameters()])).norm()) > 0
