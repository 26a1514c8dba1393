// Fused log-mel front end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/mel_frontend.py:187
// (fused_fbank / _mel_kernel): waveform -> centred frames -> window-folded
// real DFT -> power -> mel projection -> dB, in one launch, so neither the
// frames nor the power spectrum reach device memory. The per-sequence top_db
// clamp needs a maximum over all frames and stays outside, on the small
// output.
//
// What bounds it. The function itself is bound by its bytes: waveform in,
// log-mel out, 2.3 us at the memory's rate for 8 x 10 s at hop 160 (an FFT
// a frame would need less arithmetic than that). This design computes the
// DFT as a product frames (M) x tables (K = n_fft, N = 2 n_freq): at
// n_fft 400, 2.58 GFLOP, 38 us on the float32 CUDA cores at their peak, so
// it goes to the tensor cores: 7.7 GFLOP in three TF32 passes, 15.6 us at
// their peak. The mel projection is 400 times less work once its zeros are
// skipped. The design:
//
// - DFT on the tensor cores, TF32 split in three passes. One TF32 pass (10
//   mantissa bits) misses the kernel's 5e-3 dB tolerance even on white
//   noise; hi * hi + hi * lo + lo * hi, with hi the operand rounded to TF32
//   and lo the rest rounded to TF32, keeps float32's level. The tables'
//   hi and lo parts are made once on the host (ops/mel_frontend.py
//   kernel_operands); the frames' are split in registers, by the same
//   rounding.
//   Each product is wgmma.m64n104k8.f32.tf32.tf32 with A (64 frames x 8
//   samples) from registers and B (8 samples x 104 table columns) from
//   shared memory, K-major as TF32 requires, accumulating in float32: the
//   hi x hi pass in one accumulator, the two small passes in another.
// - The tables' columns are interleaved cos_k, sin_k, so the accumulator
//   pair a thread holds for columns 2t, 2t + 1 is re and im of one
//   frequency: the power is formed in registers and only the power tile
//   (64 frames x 104 frequencies, one chunk) reaches shared memory.
// - A block owns up to 64 frames (one wgmma M tile) of one utterance and
//   reads their span of the waveform into shared memory once (cp.async,
//   16-byte copies where aligned); the centre padding is made by masking
//   the index. Where 64 frames' span does not fit beside the ring (hops
//   above 268 samples at n_fft 400, 220 at n_fft 1024), a block takes 32,
//   16, ... frames: the product stays m64, its rows past the block's frames
//   read zeros, so that any hop runs.
//   Two consumer warpgroups each take half of a table tile's 208 columns,
//   so that one's frame loads and product drain overlap the other's
//   products. A's fragments are read from the span: frame f, sample n at
//   f * hop + n. K runs in whole tiles of 32 samples: samples past n_fft
//   meet zero table rows, and are masked to zeros in registers as well (4 %
//   more products at n_fft 400).
// - The span is stored skewed: `skew` (0..7) unused words after every hop
//   samples, so that frame f starts at f * (hop + skew), with hop + skew = 4
//   (mod 8). A fragment load has lanes g = 0..7 on frames g and t = 0..3 on
//   samples n + t, at banks (g (hop + skew) + t + c) mod 32: (hop + skew) g
//   runs over 0, 4, ..., 28 for g = 0..7, so the 32 lanes hit 32 banks (at
//   hop 160, 128 and 256 the skew is 4; at 161, 3; at 100, 0). Only the k8
//   step that straddles a multiple of hop (within the frame) can conflict.
// - Table tiles (208 columns x 32 samples, hi and lo: 53,248 bytes) come
//   through a ring of three stages where they fit, else two (at 80 mels
//   always two), in shared memory. The host lays them out tile by tile in
//   wgmma's 128-byte swizzled order, so one 1-D bulk copy (cp.async.bulk)
//   lands a tile ready to use: no tensor map, CUDA runtime only. One
//   producer thread (its own warp) fills the ring; the consumer warpgroups
//   wait on the stages' mbarriers and free a stage once their products have
//   read it. (Sharing each tile across a cluster of 2 or 4 blocks by
//   multicast halves the tables' L2 reads but was no faster at 2 and slower
//   at 4 on an H100: PERF.md.)
// - Mel projection on the CUDA cores over each filter's non-zero range only
//   (found from the matrix by the host, so exact for any matrix): 387 of
//   16,080 weights at 80 mels and n_fft 400. It runs chunk by chunk on the
//   power tile; a thread takes one filter for 32 frames, in registers (32
//   independent FMAs a bin: nine warps an SM hide little latency), and
//   keeps the sums in shared memory between chunks. After the last chunk it
//   takes the log, scales, offsets and writes its 32 outputs, neighbouring
//   threads on neighbouring filters (coalesced).
//
// What holds it now (PERF.md): with its products left out the kernel keeps
// most of its time. It is bound by bringing 1.39 MB of TF32 hi/lo tables
// into every SM, two 53 KB stages at a time. Folding the frames about
// n_fft / 2 (for a symmetric window) would halve the tables and the
// products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 64;          // wgmma's M: frames a block at most
constexpr int kCols = 208;           // table columns a tile (a chunk)
constexpr int kFreqs = kCols / 2;    // frequencies a chunk
constexpr int kWarpgroups = 2;       // consumers, each on half the columns
constexpr int kWgCols = kCols / kWarpgroups;  // wgmma's N
constexpr int kWgFreqs = kWgCols / 2;
constexpr int kTileK = 32;           // samples a tile: one 128-byte row
constexpr int kTileBytes = kCols * kTileK * 4;   // hi or lo part
constexpr int kStageBytes = 2 * kTileBytes;      // hi, then lo
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;        // and the producer warp
constexpr int kPowLd = kFreqs | 4;   // = 4 (mod 8): conflict-free rows
constexpr int kMaxSmem = 232448;
constexpr long long kSpinLimit = 1LL << 26;  // then trap, never hang

static_assert(kTileBytes % 1024 == 0, "tiles keep the swizzle's alignment");

struct Params {
  const float* wav;
  const float* tables;
  const int* mel_ranges;    // (n_mels, 2): first, one past last bin
  const float* mel_weights; // (n_mels, mel_width)
  float* out;
  int T, n_frames, n_fft, n_freq, n_mels, mel_width, hop, skew;
  int n_chunks, n_ktiles, stages, fpb;  // fpb: frames a block, 64 >> j
  // byte offsets from the 1024-aligned base of shared memory
  int bars, offs, span, pow, mel, rng, wts;
  float amin, multiplier, db_offset;
};

// Frames of the per-(frame, mel) sums: the mel projection works in halves
// of 32 frames.
__host__ __device__ int mel_rows(int fpb) {
  return fpb > kFrames / 2 ? kFrames : kFrames / 2;
}

// Shared memory: the ring, then the barriers (full[s], empty[s]), the
// samples' offsets in the skewed span, the span of `fpb` frames, the power
// tile, the per-(frame, mel) sums and the mel filters' ranges and weights.
// Returns the bytes needed (1024 of slack included), or -1 past a block's
// limit.
int layout(Params& p, int stages, int fpb) {
  const int kp = kTileK * p.n_ktiles;
  const long long last = (long long)(fpb - 1) * p.hop + kp - 1;
  const long long span = last + p.skew * (last / p.hop) + 1;
  long long o = (long long)stages * kStageBytes;
  p.bars = (int)o;
  o += 2 * stages * 8;
  p.offs = (int)o;
  o += kp * 4;
  o = (o + 15) / 16 * 16;
  p.span = (int)o;
  o += span * 4;
  o = (o + 15) / 16 * 16;
  p.pow = (int)o;
  o += kFrames * kPowLd * 4;
  p.mel = (int)o;
  o += (long long)mel_rows(fpb) * p.n_mels * 4;
  p.rng = (int)o;
  o += 2 * p.n_mels * 4;
  p.wts = (int)o;
  o += (long long)p.n_mels * p.mel_width * 4;
  o += 1024;
  p.stages = stages;
  p.fpb = fpb;
  return o > kMaxSmem ? -1 : (int)o;
}

// The deepest ring, then the most frames a block, that fit: sets p.stages
// and p.fpb and returns the shared memory's bytes, or -1 if even one frame
// a block does not fit.
int choose_layout(Params& p) {
  for (int fpb = kFrames; fpb >= 1; fpb /= 2) {
    for (int stages = 3; stages >= 2; --stages) {
      const int bytes = layout(p, stages, fpb);
      if (bytes > 0) return bytes;
    }
  }
  return -1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// arrive on the barrier (its default .release.cta orders the products'
// reads of the stage, complete once wgmma.wait_group has returned)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait for the phase of parity `parity` to complete; a barrier that never
// completes (a fault) traps the kernel instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// `bytes` from global memory to `dst` in this block's shared memory, their
// arrival counted on the barrier at `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 gives for finite x, in two integer
// operations at the full rate instead of a conversion (ops/mel_frontend.py
// tf32_round makes the tables' parts the same way)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// wgmma shared-memory descriptor of a K-major tile in 128-byte swizzled
// rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(16 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 16 bytes from global to shared memory, both 16-byte aligned
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// 4 bytes from global to shared memory, or 4 zero bytes where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous product owns across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d += a b: a (64 frames x 8 samples, TF32) from registers in wgmma's
// fragment layout (a[0] frame g, sample t; a[1] frame g + 8, sample t;
// a[2] and a[3] the same at sample t + 4; g = lane / 4 + 16 warp,
// t = lane % 4), b (8 samples x 104 columns, TF32) K-major from shared
// memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[kWgFreqs],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_fbank_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t ring = base;
  const uint32_t full0 = base + p.bars;           // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * p.stages;   // empty[s]: + 8 s
  int* s_off = reinterpret_cast<int*>(smem + p.offs);
  float* s_wav = reinterpret_cast<float*>(smem + p.span);
  float* s_pow = reinterpret_cast<float*>(smem + p.pow);
  float* s_mel = reinterpret_cast<float*>(smem + p.mel);
  int* s_rng = reinterpret_cast<int*>(smem + p.rng);
  float* s_wts = reinterpret_cast<float*>(smem + p.wts);

  const int tid = threadIdx.x;
  const int tiles = (p.n_frames + p.fpb - 1) / p.fpb;
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * p.fpb;
  const int kp = kTileK * p.n_ktiles;  // samples a frame, padded to tiles
  const int fs = p.hop + p.skew;  // a frame's stride in the skewed span

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // one arrival from each consumer warpgroup
      mbar_init(empty0 + 8 * s, kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int n = tid; n < kp; n += kThreads) {
    s_off[n] = n + p.skew * (n / p.hop);
  }
  // the mel filters' ranges and weights
  for (int m = tid; m < 2 * p.n_mels; m += kThreads) {
    s_rng[m] = p.mel_ranges[m];
  }
  for (int m = tid; m < p.n_mels * p.mel_width; m += kThreads) {
    s_wts[m] = p.mel_weights[m];
  }
  // the span: samples [f0 hop - n_fft / 2, + (fpb - 1) hop + kp), zeros outside
  // the waveform (the centre padding), by cp.async, so that a thread's
  // loads are all in flight at once. Skewed: segment sg (hop samples)
  // starts at sg * fs; warp w copies segments w, w + 9, ..., by 16-byte
  // copies where both sides of every segment are 16-byte aligned and the
  // chunk lies inside the waveform, else by 4-byte copies.
  const long long start = (long long)f0 * p.hop - p.n_fft / 2;
  const float* wav_b = p.wav + (size_t)b * p.T;
  const int span = (p.fpb - 1) * p.hop + kp;
  const bool vec = p.hop % 4 == 0 && fs % 4 == 0 && start % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(wav_b) % 16 == 0;
  for (int sg = tid / 32; sg * p.hop < span; sg += kThreads / 32) {
    const int len = min(p.hop, span - sg * p.hop);
    const long long q0 = start + (long long)sg * p.hop;
    const uint32_t dst = smem_addr(s_wav + sg * fs);
    if (vec) {
      for (int j = (tid % 32) * 4; j < len; j += 128) {
        const long long q = q0 + j;
        if (q >= 0 && q + 4 <= p.T) {
          cp_async16(dst + 4 * j, wav_b + q);
        } else {
          for (int e = 0; e < 4; ++e) {
            const bool valid = q + e >= 0 && q + e < p.T;
            cp_async4(dst + 4 * (j + e), valid ? wav_b + q + e : wav_b, valid);
          }
        }
      }
    } else {
      for (int j = tid % 32; j < len; j += 32) {
        const long long q = q0 + j;
        const bool valid = q >= 0 && q < p.T;
        cp_async4(dst + 4 * j, valid ? wav_b + q : wav_b, valid);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < mel_rows(p.fpb) * p.n_mels; i += kThreads) {
    s_mel[i] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int n_tiles = p.n_chunks * p.n_ktiles;
  // the role, warp-uniform by construction (a shuffle from lane 0), so that
  // ptxas sees the products' branch as uniform and does not serialise them
  const int role = __shfl_sync(0xffffffffu, tid / kConsumers, 0);
  if (role == 1) {
    // the producer: tile i (chunk i / n_ktiles, samples 32 (i % n_ktiles)
    // ...) into stage i % stages once the consumers have freed it
    if (tid == kConsumers) {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(p.tables);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % p.stages;
        mbar_wait(empty0 + 8 * s, ((i / p.stages) & 1) ^ 1);
        mbar_expect(full0 + 8 * s, kStageBytes);
        bulk_copy(ring + s * kStageBytes, src + (size_t)i * kStageBytes,
                  kStageBytes, full0 + 8 * s);
      }
    }
  } else {
    const int wg = tid / 128;  // this warpgroup's columns: wg * kWgCols on
    const int warp = tid / 32 % 4;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's frames r0 and r0 + 8
    // rows past the block's frames read zeros (and row 0's address)
    const bool v0 = r0 < p.fpb;
    const bool v1 = r0 + 8 < p.fpb;
    const float* w0 = s_wav + (v0 ? r0 : 0) * fs;
    const float* w1 = s_wav + (v1 ? r0 + 8 : 0) * fs;
    // re, im pairs of this warpgroup's frequencies: the hi x hi pass in
    // acc, the two small passes (hi x lo, lo x hi) in acc_lo, added once at
    // the end of the chunk in float32. The tensor cores' float32 sums of
    // small terms into a large running sum lose more than float32's
    // rounding: one accumulator for all three passes misses the 5e-3 dB
    // tolerance on the chirp check; two keep to it.
    float acc[kWgFreqs], acc_lo[kWgFreqs];

    // this thread's frame samples of tile kt, split into TF32 hi and lo;
    // samples past n_fft (zero table rows) and rows past the block's frames
    // are zeros
    auto load_frames = [&](int kt, uint32_t (&ahi)[4][4],
                           uint32_t (&alo)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = kt * kTileK + kk * 8 + t;
        const int o0 = s_off[n];
        const int o1 = s_off[n + 4];
        const bool k0 = n < p.n_fft;
        const bool k1 = n + 4 < p.n_fft;
        const float x[4] = {k0 && v0 ? w0[o0] : 0.f, k0 && v1 ? w1[o0] : 0.f,
                            k1 && v0 ? w0[o1] : 0.f, k1 && v1 ? w1[o1] : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[kk][e] = to_tf32(x[e]);
          alo[kk][e] = to_tf32(x[e] - __uint_as_float(ahi[kk][e]));
        }
      }
    };

    for (int c = 0; c < p.n_chunks; ++c) {
#pragma unroll
      for (int j = 0; j < kWgFreqs; ++j) acc[j] = acc_lo[j] = 0.f;
      for (int kt = 0; kt < p.n_ktiles; ++kt) {
        const int i = c * p.n_ktiles + kt;
        const int s = i % p.stages;
        uint32_t ahi[4][4], alo[4][4];
        load_frames(kt, ahi, alo);
        mbar_wait(full0 + 8 * s, (i / p.stages) & 1);
        const uint32_t bhi = ring + s * kStageBytes + wg * kWgCols * 128;
        const uint32_t blo = bhi + kTileBytes;
        wgmma_fence();
        fence_regs(acc);
        fence_regs(acc_lo);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // a k8 step moves 32 bytes along the swizzled rows
          const uint64_t dhi = desc(bhi + kk * 32);
          const uint64_t dlo = desc(blo + kk * 32);
          wgmma_tf32(acc_lo, ahi[kk], dlo, 1);
          wgmma_tf32(acc, ahi[kk], dhi, 1);
          wgmma_tf32(acc_lo, alo[kk], dhi, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(acc_lo);
        if (tid % 128 == 0) mbar_arrive(empty0 + 8 * s);  // stage s is read
      }
      // power of the chunk's 68 frequencies: accumulator pairs (4 j + 2 h,
      // + 1) are re and im of frequency 4 j + t, frame r0 + 8 h
      consumers_sync();  // the last chunk's mel sums are done with s_pow
#pragma unroll
      for (int j = 0; j < kWgFreqs / 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          const float re = acc[i] + acc_lo[i];
          const float im = acc[i + 1] + acc_lo[i + 1];
          s_pow[(r0 + 8 * h) * kPowLd + wg * kWgFreqs + 4 * j + t] =
              re * re + im * im;
        }
      }
      consumers_sync();
      // mel sums over the filters' non-zero bins in the chunk. A unit is
      // one filter and 32 frames, held in registers: 32 independent FMAs
      // a bin. After the last chunk the unit takes the log, scales,
      // offsets and writes its 32 outputs (neighbouring threads,
      // neighbouring filters: coalesced).
      const bool last = c == p.n_chunks - 1;
      const int k_lo = c * kFreqs;
      const int k_hi = min(k_lo + kFreqs, p.n_freq);
      const int units = (p.fpb > kFrames / 2 ? 2 : 1) * p.n_mels;
      for (int u = tid; u < units; u += kConsumers) {
        const int half = u < p.n_mels ? 0 : 1;
        const int m = u - half * p.n_mels;
        const int fh = half * (kFrames / 2);
        const int first = s_rng[2 * m];
        const int lo = max(first, k_lo);
        const int hi = min(s_rng[2 * m + 1], k_hi);
        if (lo >= hi && !last) continue;
        float* sm = s_mel + fh * p.n_mels + m;
        float sum[kFrames / 2];
#pragma unroll
        for (int f = 0; f < kFrames / 2; ++f) sum[f] = sm[f * p.n_mels];
        const float* pw = s_pow + fh * kPowLd;
        const float* w = s_wts + m * p.mel_width;
        for (int k = lo; k < hi; ++k) {
          const float wk = w[k - first];
#pragma unroll
          for (int f = 0; f < kFrames / 2; ++f) {
            sum[f] = fmaf(pw[f * kPowLd + k - k_lo], wk, sum[f]);
          }
        }
        if (!last) {
#pragma unroll
          for (int f = 0; f < kFrames / 2; ++f) sm[f * p.n_mels] = sum[f];
        } else {
#pragma unroll
          for (int f = 0; f < kFrames / 2; ++f) {
            const int frame = f0 + fh + f;
            if (fh + f < p.fpb && frame < p.n_frames) {
              // the clamp keeps a NaN, as torch.clamp does: fmaxf alone
              // would turn a NaN waveform into finite features
              const float v = isnan(sum[f]) ? sum[f] : fmaxf(sum[f], p.amin);
              p.out[((size_t)b * p.n_frames + frame) * p.n_mels + m] =
                  p.multiplier * log10f(v) - p.db_offset;
            }
          }
        }
      }
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel runs only after an opt-in,
// made once for each device (so never while a CUDA graph is captured, once
// a call has run outside one).
int opt_in() {
  static unsigned long long opted_in = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return -1;
  if (!(opted_in >> device & 1ULL)) {
    err = cudaFuncSetAttribute(fused_fbank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ULL << device;
  }
  return 0;
}

}  // namespace

// Shared memory (bytes) a launch of these sizes needs, -1 if it needs more
// than a block can have even at one frame a block; `stages` gets the ring's
// depth and `fpb` the frames a block.
extern "C" int sb_fused_fbank_smem(int n_fft, int n_mels, int mel_width,
                                   int hop, int skew, int* stages, int* fpb) {
  Params p{};
  p.hop = hop;
  p.skew = skew;
  p.n_mels = n_mels;
  p.mel_width = mel_width;
  p.n_ktiles = (n_fft + kTileK - 1) / kTileK;
  const int bytes = choose_layout(p);
  *stages = p.stages;
  *fpb = p.fpb;
  return bytes;
}

// Returns cudaGetLastError() of the launch, -1 for sizes or operands the
// kernel does not take, -2 when even one frame a block does not fit a
// block's shared memory.
extern "C" int sb_fused_fbank(const void* wav, const void* tables,
                              const void* mel_ranges, const void* mel_weights,
                              void* out, int B, int T, int n_frames, int n_fft,
                              int n_freq, int n_mels, int mel_width, int hop,
                              int skew, int n_chunks, int n_ktiles, float amin,
                              float multiplier, float db_offset, void* stream) {
  if (B <= 0 || T <= 0 || n_frames <= 0 || n_fft <= 0 || n_freq <= 0 ||
      n_mels <= 0 || mel_width <= 0 || hop <= 0 || skew < 0 || skew > 7 ||
      (hop + skew) % 8 != 4 || n_chunks * kFreqs < n_freq ||
      n_ktiles * kTileK < n_fft) {
    return -1;
  }
  Params p{};
  p.wav = (const float*)wav;
  p.tables = (const float*)tables;
  p.mel_ranges = (const int*)mel_ranges;
  p.mel_weights = (const float*)mel_weights;
  p.out = (float*)out;
  p.T = T;
  p.n_frames = n_frames;
  p.n_fft = n_fft;
  p.n_freq = n_freq;
  p.n_mels = n_mels;
  p.mel_width = mel_width;
  p.hop = hop;
  p.skew = skew;
  p.n_chunks = n_chunks;
  p.n_ktiles = n_ktiles;
  p.amin = amin;
  p.multiplier = multiplier;
  p.db_offset = db_offset;
  const int smem = choose_layout(p);
  if (smem < 0) return -2;
  const long long grid =
      (long long)B * ((n_frames + p.fpb - 1) / p.fpb);
  if (grid > 0x7fffffffLL) return -1;
  const int err = opt_in();
  if (err != 0) return err;
  fused_fbank_kernel<<<(unsigned)grid, kThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
