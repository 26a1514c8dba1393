"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

builds the hand-written kernels of ``speechbrain_tpu_torch/csrc`` with
``nvcc`` (at first use), holds each kernel against its plain PyTorch version
on the card, runs batched ``transcribe`` — waveform -> fused Fbank ->
convolutional front end -> 12-layer Conformer encoder -> ancestry KV beam
search fused with a KV-cached TransformerLM and a CTC prefix scorer — at the
full width of the conformer-large LibriSpeech recipe with random weights
made from a seed, and times the kernels. It prints one JSON object a line
and exits non-zero as soon as a phase fails. It needs one CUDA device and
does not run without one; there is no CPU mode.

The assembly (``Pipeline``) takes a ``device`` so that the CPU tests can
hold it against the JAX package at a small size.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from speechbrain_tpu_torch.decoders.scorer import (
    CTCScorer,
    KVTransformerLMScorer,
    ScorerBuilder,
)
from speechbrain_tpu_torch.decoders.seq2seq import S2SKVBeamSearcher
from speechbrain_tpu_torch.lobes.features import Fbank
from speechbrain_tpu_torch.lobes.models.convolution import ConvolutionFrontEnd
from speechbrain_tpu_torch.lobes.models.transformer.Transformer import (
    CACHE_LENGTH_MULTIPLE,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerASR import (
    TransformerASR,
)
from speechbrain_tpu_torch.lobes.models.transformer.TransformerLM import (
    TransformerLM,
)
from speechbrain_tpu_torch.nnet.linear import Linear
from speechbrain_tpu_torch.ops import _build, beam_attention, mel_frontend
from speechbrain_tpu_torch.utils.data_utils import pad_time_to_multiple

SR = 16000

# The main path's configuration: conformer-large encoder-decoder +
# TransformerLM-fused joint CTC/attention beam search (the LibriSpeech
# conformer_large recipe), with beam and max_decode_ratio scaled down from
# the recipe's test setting (66 / 1.0).
NORTH = dict(
    batch=8, seconds=10.0, vocab=5000, n_mels=80, fe_channels=(64, 32),
    d_model=512, nhead=8, enc_layers=12, dec_layers=6, d_ffn=2048,
    kernel_size=31, lm_d_model=768, lm_nhead=12, lm_layers=12, lm_d_ffn=3072,
    beam=10, lm_weight=0.60, ctc_weight=0.40, temperature=1.15,
    max_decode_ratio=0.2, bos=1, eos=2, blank=0, pad_multiple=128,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the float32 rate outside the tensor cores, which is the type of
# arithmetic both kernels do.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Tolerances of kernel against plain version. float32: both accumulate in
# float32 in another order. bfloat16: both round the float32 result once to
# bfloat16 (8 bits of mantissa) and may land on neighbouring values.
B1_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# dB; the tolerance of the JAX package's own test of its fused kernel
B3_ATOL = 5e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


class Pipeline:
    """waveform -> hypotheses, assembled from the port's public modules."""

    def __init__(self, cfg, device="cuda", dtype=torch.float32, seed=0,
                 ancestry=True):
        C = dict(cfg)
        self.cfg = C
        self.device = torch.device(device)
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        kw = dict(device=device, dtype=dtype, generator=gen)
        self.fbank = Fbank(n_mels=C["n_mels"], fused=True, device=device)
        self.frontend = ConvolutionFrontEnd(
            num_blocks=2, out_channels=C["fe_channels"], kernel_sizes=(3, 3),
            strides=(2, 2), **kw,
        ).eval()
        # two stride-2 blocks leave ceil(ceil(n_mels / 2) / 2) mel bins
        n_feat = (C["n_mels"] + 3) // 4 * C["fe_channels"][-1]
        self.net = TransformerASR(
            tgt_vocab=C["vocab"], input_size=n_feat, d_model=C["d_model"],
            nhead=C["nhead"], num_encoder_layers=C["enc_layers"],
            num_decoder_layers=C["dec_layers"], d_ffn=C["d_ffn"],
            encoder_module="conformer", attention_type="RelPosMHAXL",
            kernel_size=C["kernel_size"], normalize_before=True, **kw,
        ).eval()
        self.ctc_lin = Linear(C["vocab"], C["d_model"], **kw)
        self.seq_lin = Linear(C["vocab"], C["d_model"], **kw)
        self.lm = TransformerLM(
            vocab=C["vocab"], d_model=C["lm_d_model"], nhead=C["lm_nhead"],
            num_encoder_layers=C["lm_layers"], d_ffn=C["lm_d_ffn"],
            dropout=0.0, activation="gelu", normalize_before=False, **kw,
        ).eval()
        self.ancestry = ancestry
        self.fbank_calls = 0
        self.searcher = None
        self.last_max_steps = None
        self.last_encode_ms = None
        self.last_decode_ms = None

    def _build_searcher(self, max_steps):
        C = self.cfg
        net, lm = self.net, self.lm

        def decode_step_fn(toks, cache, enc_states, enc_lens, step, anc=None):
            out, cache, attn = net.decode_step(
                toks, enc_states, cache, step, anc=anc
            )
            logits = self.seq_lin(out).float()
            # temperature on LOGITS; the searcher applies none itself
            return (
                torch.log_softmax(logits / C["temperature"], dim=-1),
                cache, attn,
            )

        scorer = ScorerBuilder(
            weights={"ctc": C["ctc_weight"],
                     "transformerlm": C["lm_weight"]},
            full_scorers={
                "transformerlm": KVTransformerLMScorer(
                    step_fn=lm.score_step,
                    init_cache_fn=lm.init_cache,
                    max_length=max_steps + 1,
                    temperature=C["temperature"],
                    # ancestry beam decoding: LM cache rows never move
                    ancestry=self.ancestry,
                )
            },
            partial_scorers={
                "ctc": CTCScorer(
                    ctc_fn=lambda enc: torch.log_softmax(
                        self.ctc_lin(enc).float(), dim=-1
                    ),
                    blank_index=C["blank"], eos_index=C["eos"],
                )
            },
        )
        return S2SKVBeamSearcher(
            decode_step_fn,
            # precomputed cross-attention K/V, kept per utterance and
            # broadcast over the beams inside the attention
            lambda n, enc, lens: net.init_decoder_cache_with_cross(
                enc, max_steps + 1, n
            ),
            shared_cross_kv=True, ancestry_kv=self.ancestry,
            bos_index=C["bos"], eos_index=C["eos"], min_decode_ratio=0.0,
            max_decode_ratio=C["max_decode_ratio"], beam_size=C["beam"],
            using_eos_threshold=False, length_normalization=True,
            temperature=C["temperature"], scorer=scorer, device=self.device,
        )

    @torch.no_grad()
    def encode(self, wavs, lens):
        feats = self.fbank(wavs)
        self.fbank_calls += 1
        sub = self.frontend(feats.to(self.dtype))
        sub, lens_p = pad_time_to_multiple(
            sub, lens, multiple=self.cfg["pad_multiple"]
        )
        return self.net.encode(sub, wav_len=lens_p), lens_p

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def transcribe(self, wavs, lens):
        """(B, T) waveforms and relative lengths -> (hyps, lengths,
        scores, topk), as the searcher returns them."""
        self._sync()
        t0 = time.perf_counter()
        enc, lens_p = self.encode(wavs, lens)
        self._sync()
        t1 = time.perf_counter()
        max_steps = max(1, int(enc.shape[1] * self.cfg["max_decode_ratio"]))
        self.last_max_steps = max_steps
        self.searcher = self._build_searcher(max_steps)
        result = self.searcher(enc, lens_p)
        self._sync()
        t2 = time.perf_counter()
        self.last_encode_ms = (t1 - t0) * 1e3
        self.last_decode_ms = (t2 - t1) * 1e3
        return result


@contextlib.contextmanager
def plain_versions():
    """Route the two wrappers' CUDA arm to the kernels' plain PyTorch
    versions (same signatures), for the comparison phases only. The
    package itself has no such switch: on a CUDA tensor its wrappers
    launch the kernel or raise."""
    saved = (beam_attention._ancestry_attention_cuda,
             mel_frontend._fused_fbank_cuda)
    beam_attention._ancestry_attention_cuda = (
        beam_attention.ancestry_attention_reference
    )
    mel_frontend._fused_fbank_cuda = mel_frontend.fused_fbank_reference
    try:
        yield
    finally:
        (beam_attention._ancestry_attention_cuda,
         mel_frontend._fused_fbank_cuda) = saved


def reset_launch_counts():
    beam_attention.launches = 0
    mel_frontend.launches = 0


def time_eager_ms(fn, n_variants, iters=50, warmup=5):
    """Mean milliseconds of ``fn(i)`` called back to back from Python, by
    CUDA events: the rate at which an eager loop can issue the call, host
    overhead included. ``i`` cycles through ``n_variants`` input sets so
    that each launch finds its inputs out of the L2 cache, as the main
    path's launches do."""
    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_variants)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, n_variants, iters=48):
    """Mean milliseconds of ``fn(i)`` on the device: ``iters`` calls are
    captured into one CUDA graph and the graph's replay is timed by CUDA
    events, so the host's time to issue each call is left out. Inputs
    cycle as in :func:`time_eager_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_variants)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_variants)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


# -- phase 2: each kernel against its plain version ------------------------

def make_b1_inputs(B, K, H, hd, L, dtype, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    D = H * hd
    q = torch.from_numpy(
        rng.standard_normal((B, K, H, hd)).astype(np.float32)
    ).to(device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((B, K, L, D), generator=gen, device=device).to(dtype)
    v = torch.randn((B, K, L, D), generator=gen, device=device).to(dtype)
    anc = torch.from_numpy(
        rng.integers(0, K, (B, K, L)).astype(np.int32)
    ).to(device)
    return q, k, v, anc


def check_b1():
    results = []
    worst = 0.0
    cases = [
        (8, 10, 8, 64, 64, torch.float32), (8, 10, 8, 64, 64, torch.bfloat16),
        (8, 10, 12, 64, 64, torch.float32),
        (8, 10, 12, 64, 64, torch.bfloat16),
    ]
    for B, K, H, hd, L, dtype in cases:
        q, k, v, anc = make_b1_inputs(B, K, H, hd, L, dtype, seed=H + L)
        for step in (0, 31, 32, L - 1):
            out = beam_attention.ancestry_attention(q, k, v, anc, step)
            torch.cuda.synchronize()
            ref = beam_attention.ancestry_attention_reference(
                q, k, v, anc, step
            )
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= B1_ATOL[dtype]) or out.shape != ref.shape:
                raise AssertionError(
                    f"ancestry_attention disagrees: shape {(B, K, H, hd, L)}"
                    f" {dtype} step {step}: max abs err {err}"
                )
            worst = max(worst, err)
            results.append([H, str(dtype), step, err])
    # the published decode's shape: beam 66, 288 positions, LM heads
    B, K, H, hd, L, dtype = 8, 66, 12, 64, 288, torch.bfloat16
    q, k, v, anc = make_b1_inputs(B, K, H, hd, L, dtype, seed=66)
    out = beam_attention.ancestry_attention(q, k, v, anc, L - 1)
    torch.cuda.synchronize()
    ref = beam_attention.ancestry_attention_reference(q, k, v, anc, L - 1)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= B1_ATOL[dtype]:
        raise AssertionError(
            f"ancestry_attention disagrees at beam 66: max abs err {err}"
        )
    worst = max(worst, err)
    emit({"phase": "kernel_check", "kernel": "ancestry_attention",
          "atol": {str(k_): v_ for k_, v_ in B1_ATOL.items()},
          "cases_H_dtype_step_err": results, "beam66_L288_bf16_err": err,
          "max_abs_err": worst})
    return worst


def check_b3():
    worst = 0.0
    rows = []
    for batch, seconds, hop_ms in ((8, 10.0, 10), (2, 4.0, 8), (2, 4.0, 16)):
        wav = torch.from_numpy(
            np.random.default_rng(int(hop_ms)).standard_normal(
                (batch, int(SR * seconds))
            ).astype(np.float32)
        ).cuda()
        fused = Fbank(n_mels=80, hop_length=hop_ms, fused=True)
        unfused = Fbank(n_mels=80, hop_length=hop_ms, fused=False)
        out = fused(wav)
        torch.cuda.synchronize()
        with plain_versions():
            plain = fused(wav)
        ref = unfused(wav)
        err_plain = (out - plain).abs().max().item()
        err_unfused = (out - ref).abs().max().item()
        hop = fused.compute_STFT.hop_length
        if out.shape != ref.shape or not (
            err_plain <= B3_ATOL and err_unfused <= B3_ATOL
        ):
            raise AssertionError(
                f"fused_fbank disagrees at hop {hop}: vs plain {err_plain}, "
                f"vs unfused Fbank {err_unfused} dB"
            )
        worst = max(worst, err_plain, err_unfused)
        rows.append({"shape": list(wav.shape), "hop": hop,
                     "frames": out.shape[1], "err_vs_plain": err_plain,
                     "err_vs_unfused_fbank": err_unfused})
    emit({"phase": "kernel_check", "kernel": "fused_fbank",
          "atol_db": B3_ATOL, "cases": rows, "max_abs_err": worst})
    return worst


# -- phase 3: the main path -------------------------------------------------

def make_waveforms(cfg, device):
    wavs = np.random.default_rng(0).standard_normal(
        (cfg["batch"], int(SR * cfg["seconds"]))
    ).astype(np.float32)
    return (
        torch.from_numpy(wavs).to(device),
        torch.ones(cfg["batch"], device=device),
    )


def run_main_path(cfg):
    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    pipe.transcribe(wavs, lens)  # warm-up: cuDNN/cuBLAS set-up, allocator
    reset_launch_counts()
    pipe.fbank_calls = 0
    hyps, lengths, scores, _ = pipe.transcribe(wavs, lens)
    b1_launches = beam_attention.launches
    b3_launches = mel_frontend.launches
    steps = pipe.searcher.last_steps
    per_step = cfg["dec_layers"] + cfg["lm_layers"]
    ok = (
        len(hyps) == cfg["batch"]
        and np.all(np.isfinite(scores))
        and all(0 <= t < cfg["vocab"] for h in hyps for t in h)
        and steps >= 1
        and b1_launches == per_step * steps
        and b3_launches == pipe.fbank_calls >= 1
    )
    audio_s = cfg["batch"] * cfg["seconds"]
    total_ms = pipe.last_encode_ms + pipe.last_decode_ms
    emit({
        "phase": "main_path", "dtype": "bfloat16", "ok": bool(ok),
        "config": {**cfg, "ctc_scorer": True,
                   "fused_fbank": True, "ancestry_kv": True},
        "hypotheses": len(hyps), "hyp_lengths": [int(x) for x in lengths],
        "scores": [float(s) for s in scores], "steps": steps,
        "ancestry_attention_launches": b1_launches,
        "fused_fbank_launches": b3_launches,
        "encode_ms": pipe.last_encode_ms, "decode_ms": pipe.last_decode_ms,
        "audio_seconds_per_second": audio_s / (total_ms / 1e3),
    })
    if not ok:
        raise AssertionError("main path: a check on the bf16 run failed")
    return {"steps": steps, "max_steps": pipe.last_max_steps,
            "b1": b1_launches, "b3": b3_launches}


def run_fp32_comparison(cfg, score_atol=1e-3):
    """The same transcribe in float32, through the kernels and through the
    plain versions: tokens equal, scores within ``score_atol`` (the two
    differ by float32 summation order only; the slack is for its growth
    through 18 layers and up to 51 steps)."""
    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.float32, seed=0)
    reset_launch_counts()
    hyps_k, _, scores_k, _ = pipe.transcribe(wavs, lens)
    used_kernels = beam_attention.launches > 0 and mel_frontend.launches > 0
    reset_launch_counts()
    with plain_versions():
        hyps_p, _, scores_p, _ = pipe.transcribe(wavs, lens)
    plain_clean = beam_attention.launches == 0 and mel_frontend.launches == 0
    diff = float(np.max(np.abs(scores_k - scores_p)))
    ok = (
        used_kernels and plain_clean and hyps_k == hyps_p
        and diff <= score_atol
    )
    emit({"phase": "fp32_kernel_vs_plain", "ok": bool(ok),
          "tokens_equal": hyps_k == hyps_p, "max_score_diff": diff,
          "score_atol": score_atol,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    if not ok:
        raise AssertionError("fp32: kernel path and plain path disagree")


# -- phase 4: times and bounds ---------------------------------------------

def b1_work(B, K, D, n_pos, itemsize):
    """Bytes and operations of one ancestry attention launch that attends
    over ``n_pos`` positions: K and V rows read once, the ancestry entries
    read, q read and out written; 4 flops per element of K/V."""
    nbytes = (
        2 * B * K * n_pos * D * itemsize + B * K * n_pos * 4
        + 2 * B * K * D * itemsize
    )
    return nbytes, 4 * B * K * n_pos * D


def measure_b1(cfg, steps, max_steps, launches, err):
    """Per-launch time at the main path's two shapes (decoder and LM
    heads), bfloat16, at the last step that ran (the longest history).
    The line's numbers are the mean over one decode step's launches."""
    B, K = cfg["batch"], cfg["beam"]
    L = -(-(max_steps + 1) // CACHE_LENGTH_MULTIPLE) * CACHE_LENGTH_MULTIPLE
    last = steps - 1
    shapes = [(cfg["nhead"], cfg["dec_layers"]),
              (cfg["lm_nhead"], cfg["lm_layers"])]
    per_shape = []
    for H, n_layers in shapes:
        D = H * 64
        set_bytes = 2 * B * K * L * D * 2
        n_sets = max(2, -(-120_000_000 // set_bytes))  # > 2x the 50 MB L2
        sets = [
            make_b1_inputs(B, K, H, 64, L, torch.bfloat16, seed=i)
            for i in range(n_sets)
        ]

        def kernel(i, step=last):
            return beam_attention.ancestry_attention(*sets[i], step)

        def plain(i):
            return beam_attention.ancestry_attention_reference(
                *sets[i], last
            )

        nbytes, flops = b1_work(B, K, D, last + 1, 2)
        by_step = {}
        for step in sorted({0, last // 2, last}):
            step_bytes, _ = b1_work(B, K, D, step + 1, 2)
            by_step[str(step)] = {
                "ms": time_ms(lambda i, s_=step: kernel(i, s_), n_sets),
                "bound_ms": step_bytes / PEAK_BYTES_PER_S * 1e3,
            }
        per_shape.append({
            "H": H, "layers": n_layers,
            "ms": by_step[str(last)]["ms"],
            "eager_call_ms": time_eager_ms(kernel, n_sets),
            "plain_ms": time_ms(plain, n_sets, iters=8),
            "plain_eager_call_ms": time_eager_ms(plain, n_sets, iters=10,
                                                 warmup=2),
            "bytes": nbytes, "flops": flops,
            "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "flops_ms": flops / PEAK_FP32_FLOPS * 1e3,
            "ms_by_step": by_step,
        })
        del sets
        torch.cuda.empty_cache()
    n = sum(s["layers"] for s in per_shape)

    def mean(key):
        return sum(s[key] * s["layers"] for s in per_shape) / n

    bytes_ms, flops_ms = mean("bytes_ms"), mean("flops_ms")
    ms = mean("ms")
    return {
        "name": "ancestry_attention", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/beam_attention.cu",
        "replaces": "speechbrain_tpu/ops/beam_attention.py:212",
        "launches": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": mean("plain_ms"), "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None, "eager_call_ms": mean("eager_call_ms"),
        "plain_eager_call_ms": mean("plain_eager_call_ms"),
        "timed_at_step": last, "dtype": "bfloat16", "per_shape": per_shape,
    }


def measure_b3(cfg, launches, err):
    B, T = cfg["batch"], int(SR * cfg["seconds"])
    fused = Fbank(n_mels=cfg["n_mels"], fused=True)
    n_sets = 16  # 16 x 5 MB of waveform: more than the 50 MB L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    wavs = [torch.randn((B, T), generator=gen, device="cuda")
            for _ in range(n_sets)]
    ms = time_ms(lambda i: fused(wavs[i]), n_sets, iters=32)
    eager_ms = time_eager_ms(lambda i: fused(wavs[i]), n_sets, iters=32)
    with plain_versions():
        plain_ms = time_ms(lambda i: fused(wavs[i]), n_sets, iters=16)
    n_fft = fused.compute_STFT.n_fft
    n_freq = n_fft // 2 + 1
    n_mels = cfg["n_mels"]
    n_frames = 1 + T // fused.compute_STFT.hop_length
    flops = B * n_frames * (2 * 2 * n_fft * n_freq + 2 * n_freq * n_mels)
    nbytes = (
        B * T * 4 + B * n_frames * n_mels * 4
        + 2 * n_fft * n_freq * 4 + n_freq * n_mels * 4
    )
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return {
        "name": "fused_fbank", "route": "cuda",
        "source": "speechbrain_tpu_torch/csrc/mel_frontend.cu",
        "replaces": "speechbrain_tpu/ops/mel_frontend.py:187",
        "launches": launches, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None, "eager_call_ms": eager_ms, "bytes": nbytes,
        "flops": flops,
        "note": "ms and plain_ms include the top_db clamp on the output",
    }


def profile_decode(cfg):
    """``--profile`` only: one beam search of the main path under
    ``torch.profiler``; device time by kernel, and the device's busy share
    of the search's wall time as measured without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wavs, lens = make_waveforms(cfg, "cuda")
    pipe = Pipeline(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    pipe.transcribe(wavs, lens)
    pipe.transcribe(wavs, lens)
    decode_ms, steps = pipe.last_decode_ms, pipe.searcher.last_steps
    enc, lens_p = pipe.encode(wavs, lens)
    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        pipe.searcher(enc, lens_p)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us))
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3
    n_kernels = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    emit({
        "phase": "profile_decode", "steps": steps,
        "decode_ms_unprofiled": decode_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / decode_ms,
        "device_kernels": n_kernels, "kernels_per_step": n_kernels / steps,
        "top_kernels_name_count_ms": [
            [r[0][:80], r[1], r[2] / 1e3] for r in rows[:12]
        ],
    })


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace one beam search with torch.profiler and print "
             "the device's busy share and the heaviest kernels",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 1
    # float32 products in full float32 everywhere, cuDNN's convolutions
    # included (they default to TF32), so that float32 phases compare
    # like with like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu_name_power_limit": smi,
          "kernel_build_seconds": _build.last_build_seconds,
          "kernel_load_seconds": time.perf_counter() - t0,
          "nvcc_flags": list(_build.NVCC_FLAGS)})

    err_b1 = check_b1()
    err_b3 = check_b3()
    counts = run_main_path(NORTH)
    run_fp32_comparison(NORTH)
    kernels = [
        measure_b1(NORTH, counts["steps"], counts["max_steps"], counts["b1"],
                   err_b1),
        measure_b3(NORTH, counts["b3"], err_b3),
    ]
    if args.profile:
        profile_decode(NORTH)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
