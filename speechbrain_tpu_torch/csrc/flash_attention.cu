// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D) + bias) v
// with an online softmax; the (Tq, Tk) scores never reach device memory.
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/attention.py
// (flash_attention / _flash_kernel / _no_bias_kernel). The TPU kernel pads
// Tq and Tk to 128 with copies of q, k, v and the bias (padding biased by
// NEG_INF / 2), reshapes the bias to (B*H, Tq, Tk) and walks 128-key blocks
// in a sequential loop. Here nothing is padded or copied: q, k, v and out
// go through their strides (unit stride along D), and the bias through its
// four strides, with stride 0 on the axes it is broadcast along, so the
// shapes (Tq, Tk), (B, 1, 1, Tk), (1, 1, Tq, Tk) and (B, H, Tq, Tk) all run
// as they are.
//
// What bounds it. A launch does 4 * B * H * Tq * Tk * D flops on
// B * H * (2 Tq + 2 Tk) * D elements read or written: about Tk / 2 flops a
// byte in bf16 for self-attention, against the bf16 tensor cores' ridge of
// about 295. At 1024 keys it is bound by operations, at 256 keys (the
// encoder's shape) by bytes, and there, with 128 blocks on 132 SMs, each
// walking four key tiles, by the latency of its loads as much as their
// number. Only the tensor cores come near either bound.
//
// bfloat16 (tc::kernel), the design for both:
// - Products on wgmma. A block of two warpgroups owns one
//   (batch, head) and 128 query rows, 64 a warpgroup. S = (q / sqrt(D)) K^T
//   is wgmma.m64n64k16 with q and the K tile read from shared memory (both
//   K-major); O += P V is wgmma.m64nDk16 with P from registers and V read
//   from shared memory through the transpose bit of the 16-bit B operand,
//   so V is not transposed in memory. Accumulation is in float32.
// - q is scaled by 1 / sqrt(D) before the first product, as the JAX kernel
//   does: each thread widens its 16 bytes of q to float32, multiplies, and
//   rounds the product to bf16 as it stores it into shared memory (JAX's
//   q_ref[0] * scale rounds it in q's dtype too). P is rounded to bf16 in
//   registers, as in any flash kernel; its row sums stay in float32.
// - Asynchronous K/V tiles of 64 keys: a ring of three shared-memory
//   stages (two where a bias tile makes three too large) filled by
//   cp.async (16-byte copies, cache-global) two tiles ahead (one with two
//   stages), so that the loads overlap the products. Rows past Tk are zero-filled by
//   the copy itself (source size 0) and their keys masked to -inf by index
//   in the last tile. cp.async and not TMA: the kernel takes any strides on
//   the batch, head and time axes (the views of MultiheadAttention._heads,
//   size-1 axes of any stride), needs no tensor map built on the host at
//   each call and no driver-API entry point; the copies cost each thread
//   two to eight 16-byte copies a tile, four more with a bias tile.
// - Shared-memory tiles are stored in rows of 128 bytes (64 bytes at D 32)
//   with the 128-byte (64-byte) swizzle that wgmma's descriptors name, so
//   the cp.async writes and the tensor cores' reads are free of bank
//   conflicts.
// - Two blocks an SM at D 32 and 64 (at most 128 registers a thread, at
//   most half the SM's shared memory a block): the softmax, whose
//   arithmetic costs a block about as much time as its products, then runs
//   beside the other block's products. At D 128 (64 float32 accumulators
//   of O a thread) one block an SM.
// - Online softmax in registers, in the accumulator's own fragment layout:
//   a thread holds two rows, and row maxima are reduced by shuffles within
//   the quad of lanes that share a row, from four partial maxima a row (so
//   that no chain of dependent operations is longer than 4); the
//   denominators are reduced once, at the end. A row whose every score so
//   far is -inf subtracts 0, so that exp gives 0 and not NaN, and is
//   written as zeros.
// - The bias: where its rows are 16-byte aligned and Tk fills whole 16-byte
//   chunks (every form make_mask_bias builds at the shapes the port runs),
//   its tile rides the ring with K and V, one row only where every query
//   row shares it (the key-padding form, row stride 0), and each thread
//   reads its fragment elements from shared memory. Elsewhere each thread
//   reads them from device memory, issued while S runs (slower than the
//   ring at the flash path's shapes: PERF.md).
// - Shared memory, no bias / bf16 bias: 33 / 87 KB at D 32, 65 / 85 KB at
//   D 64, 97 / 133 KB at D 128.
//
// float32 (core::kernel) keeps the CUDA-core kernel: the float32 check holds
// the kernel to 2e-5 of a float32 reference, which rules out the tensor
// cores' TF32 (10 bits of mantissa). A block of 256 threads owns 64 query
// rows; q / sqrt(D) and each 64-key K/V tile are staged in shared memory as
// float32 and a 16 x 16 grid of threads holds 4 x 4 score tiles.
//
// What a later change could still take: warp specialisation (a producer
// warp feeding the ring by TMA while the two consumer warpgroups take turns
// on the tensor cores, with mbarriers in place of the block-wide barrier a
// tile), and a persistent grid of one or two blocks an SM walking the
// (batch, head, query tile) space, so that one tile's epilogue overlaps the
// next one's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Strides {
  long long b, h, t;  // elements; the last axis has unit stride
};

// Above 48 KB of dynamic shared memory a kernel runs only after an opt-in,
// made once for each device that kernel runs on (so never while a CUDA
// graph is being captured, once a call has run outside one).
template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes, unsigned long long* opted_in) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return -1;
  if (!(*opted_in >> device & 1ULL)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    *opted_in |= 1ULL << device;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace core {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
static_assert(kBQ == kBK, "load_tile stages kBK rows of q as of k and v");
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = 4;        // floats of padding a shared-memory row

// Rows [r0, r0 + 64) of a (n, HD) matrix with row stride `st`, times `mul`,
// into shared memory with row stride HD + kPad; rows >= n become zeros.
template <int HD>
__device__ void load_tile(const float* __restrict__ base, long long st,
                          int r0, int n, float mul, float* __restrict__ s) {
  constexpr int CPR = HD / 4;  // 16-byte chunks a row
  constexpr int LD = HD + kPad;
  for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
    const int r = c / CPR;
    const int d = (c % CPR) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      f = *reinterpret_cast<const float4*>(base + (long long)(r0 + r) * st + d);
    }
    *reinterpret_cast<float4*>(s + r * LD + d) =
        make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ bias,
       float* __restrict__ out, int H, int Tq, int Tk, int n_qt, Strides sq,
       Strides sk, Strides sv, Strides sb, Strides so, float scale) {
  constexpr int LD = HD + kPad;    // row stride of sQ, sK, sV
  constexpr int LDP = kBK + kPad;  // row stride of sP
  constexpr int CPT = HD / 16;     // output columns a thread
  static_assert(HD % 32 == 0 && HD <= 128, "head dim 32, 64 or 128");

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int c0 = tx * CPT;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* biasb = bias == nullptr ? nullptr : bias + b * sb.b + h * sb.h;

  load_tile<HD>(qb, sq.t, q0, Tq, scale, sQ);

  float acc[4][CPT];
  float m_run[4];
  float l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // the last tile's readers are done with sK, sV, sP
    load_tile<HD>(kb, sk.t, k0, Tk, 1.f, sK);
    load_tile<HD>(vb, sv.t, k0, Tk, 1.f, sV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LD + d);
        kv[i] = *reinterpret_cast<const float4*>(sK + (tx + 16 * i) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Tk) {
          s[i][j] = -INFINITY;
        } else if (biasb != nullptr && row < Tq) {
          s[i][j] += biasb[(long long)row * sb.t + col];
        }
      }
      // the 16 lanes of a row are lanes 0-15 or 16-31 of one warp
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m_run[i], mx);
      // all scores so far -inf: subtract 0, so that exp gives 0, not NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * LDP + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
        const float* vrow = sV + (j + jj) * LD + c0;
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CPT; c += 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = t.x; vv[c + 1] = t.y; vv[c + 2] = t.z; vv[c + 3] = t.w;
          }
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x
                        : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ob[(long long)row * so.t + c0 + c] = acc[i][c] * inv;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int Tq, int Tk, const Strides* st,
           cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(float) *
      (kBQ * (HD + kPad) + 2 * kBK * (HD + kPad) + kBQ * (kBK + kPad));
  static unsigned long long opted_in = 0;
  const int err = opt_in_smem(kernel<HD>, bytes, &opted_in);
  if (err != 0) return err;
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return -1;
  kernel<HD><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, H, Tq, Tk, n_qt, st[0], st[1], st[2], st[3], st[4],
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace core

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;            // warpgroups a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;     // query rows a block
constexpr float kLog2e = 1.4426950408889634f;

struct NoBias {};

template <int HD>
struct Tile {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dim 32, 64 or 128");
  static constexpr int BK = 64;  // keys a tile: S is 32 registers a thread
  // a swizzle row: 64 elements (128 bytes), or the whole row at D 32
  static constexpr int W = HD < 64 ? HD : 64;
  static constexpr int ROWB = 2 * W;
  static constexpr uint32_t SWZ = ROWB == 128 ? 7 : 3;
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;
  static constexpr int UNITS = HD / 8;   // 16-byte units a row
  static constexpr int KSTEPS_ROW = W / 16;  // k16 steps a swizzle row
  static constexpr int Q_BYTES = kBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;  // K or V, one stage
};

// The shared memory of one block: q, then a ring of stages, each a K tile,
// a V tile and, for a bias of ESZ bytes an element, its (kBQ, BK) tile in
// rows padded by 16 bytes (so that the eight rows a warp reads at once fall
// on different banks). Three stages where they fit in half of the 227 KB an
// SM has (two blocks an SM), else two.
template <int HD, int ESZ>
struct Ring {
  using T = Tile<HD>;
  static constexpr int BIAS_LD = ESZ ? T::BK * ESZ + 16 : 0;
  static constexpr int BIAS_BYTES = kBQ * BIAS_LD;
  static constexpr int STAGE_BYTES = 2 * T::KV_BYTES + BIAS_BYTES;
  // 1024 bytes of slack to align the tiles to the swizzle's period
  static constexpr int bytes(int stages) {
    return 1024 + T::Q_BYTES + stages * STAGE_BYTES;
  }
  static constexpr int STAGES = bytes(3) <= 232448 / 2 ? 3 : 2;
  static constexpr int SMEM = bytes(STAGES);
};

// How the bias reaches the softmax: through the ring, its rows copied by
// cp.async with K and V (kTileRows, or kOneRow where every query row has
// the same bias: its row stride is 0); or, where its rows are not 16-byte
// aligned, read from device memory by each thread for its own fragment
// elements (kDirect).
enum BiasMode { kDirect = 0, kTileRows = 1, kOneRow = 2 };

// Byte offset of the 16-byte unit u (0 <= u < HD / 8) of row r in a tile of
// R rows. The tile is stored as HD / W column chunks of R rows of ROWB
// bytes; within a chunk, bits 4.. of the offset are XORed with bits 7.. (the
// Swizzle<3,4,3> / Swizzle<2,4,3> pattern of wgmma's 128- and 64-byte
// swizzled layouts).
template <int HD>
__device__ __forceinline__ uint32_t swizzled(int R, int r, int u) {
  using T = Tile<HD>;
  constexpr int UPR = T::ROWB / 16;
  const uint32_t o = (uint32_t)((u / UPR) * R * T::ROWB + r * T::ROWB +
                                (u % UPR) * 16);
  return o ^ (((o >> 7) & T::SWZ) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading- and
// stride-dimension byte offsets (16-byte units), swizzle layout
template <int HD>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | Tile<HD>::LAYOUT << 62;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= a b with a (64 x 16) and b (16 x 64) read from shared memory,
// both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= a b with a (64 x 16) and b (16 x 128) read from shared memory,
// both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b with a (64 x 16) in registers and b (16 x 32) read from shared
// memory MN-major (the transpose bit set: b's rows run along N)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b with a (64 x 16) in registers and b (16 x 64) read from shared
// memory MN-major (the transpose bit set: b's rows run along N)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b with a (64 x 16) in registers and b (16 x 128) read from shared
// memory MN-major (the transpose bit set: b's rows run along N)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

template <typename BT>
__device__ __forceinline__ float to_float(BT x) {
  if constexpr (std::is_same<BT, float>::value) return x;
  else return __bfloat162float(x);
}

// two neighbouring elements, from an address aligned to both
template <typename BT>
__device__ __forceinline__ float2 load_pair(const void* p) {
  if constexpr (std::is_same<BT, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

// The K and V rows [k0, k0 + BK) of one (batch, head) into a ring stage,
// by cp.async; rows past Tk are filled with zeros (from a valid address,
// row 0, read for no bytes).
template <int HD>
__device__ __forceinline__ void load_kv(uint32_t sK, uint32_t sV,
                                        const bf16* __restrict__ kb,
                                        const bf16* __restrict__ vb,
                                        long long skt, long long svt, int k0,
                                        int Tk) {
  using T = Tile<HD>;
  constexpr int N = T::BK * T::UNITS;
  static_assert(N % kThreads == 0, "whole trips");
#pragma unroll
  for (int trip = 0; trip < N / kThreads; ++trip) {
    const int i = threadIdx.x + trip * kThreads;
    const int r = i / T::UNITS;
    const int u = i % T::UNITS;
    const bool valid = k0 + r < Tk;
    const long long row = valid ? k0 + r : 0;
    const uint32_t off = swizzled<HD>(T::BK, r, u);
    cp_async16(sK + off, kb + row * skt + u * 8, valid);
    cp_async16(sV + off, vb + row * svt + u * 8, valid);
  }
}

// Rows [q0, q0 + rows) and keys [k0, k0 + BK) of the bias into a ring
// stage, by cp.async; what lies past Tq or Tk is filled with zeros. Every
// row of the bias is 16-byte aligned and Tk * ESZ a multiple of 16, so a
// 16-byte chunk lies wholly inside the keys or wholly past them.
template <int HD, typename BE>
__device__ __forceinline__ void load_bias(uint32_t sB,
                                          const BE* __restrict__ biasb,
                                          long long sbt, int q0, int Tq,
                                          int k0, int Tk, int rows) {
  constexpr int BK = Tile<HD>::BK;
  constexpr int CPR = BK * (int)sizeof(BE) / 16;  // chunks a row
  constexpr int PER = 16 / (int)sizeof(BE);       // keys a chunk
  constexpr int LD = Ring<HD, (int)sizeof(BE)>::BIAS_LD;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool valid = q0 + r < Tq && k0 + c * PER < Tk;
    const BE* src = valid ? biasb + (long long)(q0 + r) * sbt + k0 + c * PER
                          : biasb;
    cp_async16(sB + r * LD + c * 16, src, valid);
  }
}

template <int HD, typename BT>
__global__ void __launch_bounds__(kThreads, HD == 128 ? 1 : 2)  // blocks an SM
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const void* __restrict__ bias_,
       bf16* __restrict__ out, int H, int Tq, int Tk, int n_qt, Strides sq,
       Strides sk, Strides sv, Strides sb, Strides so, int bias_mode,
       float scale) {
  using T = Tile<HD>;
  constexpr int BK = T::BK;
  constexpr bool kBias = !std::is_same<BT, NoBias>::value;
  using BE = typename std::conditional<kBias, BT, float>::type;
  using R = Ring<HD, kBias ? (int)sizeof(BE) : 0>;
  constexpr int kStages = R::STAGES;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem0 =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  uint8_t* smem = smem_raw + (smem0 -
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  // stage st: K tile at ring + st * STAGE_BYTES, V tile KV_BYTES after
  // it, then the bias tile
  const uint32_t sQ = smem0;
  const uint32_t ring = sQ + T::Q_BYTES;

  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  // the two rows of this thread's accumulator fragments, and the first of
  // its columns in each group of 8
  const int row0 = q0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int c0 = (lane % 4) * 2;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const BE* biasb = nullptr;
  if constexpr (kBias) {
    biasb = static_cast<const BE*>(bias_) + b * sb.b + h * sb.h;
  }

  // the copies of key tile jt into its ring stage, as one cp.async group
  auto load_tile = [&](int jt) {
    const uint32_t stage = ring + (jt % kStages) * R::STAGE_BYTES;
    load_kv<HD>(stage, stage + T::KV_BYTES, kb, vb, sk.t, sv.t, jt * BK, Tk);
    if constexpr (kBias) {
      if (bias_mode != kDirect) {
        load_bias<HD, BE>(stage + 2 * T::KV_BYTES, biasb, sb.t, q0, Tq,
                          jt * BK, Tk, bias_mode == kOneRow ? 1 : kBQ);
      }
    }
  };
  const int nk = (Tk + BK - 1) / BK;
#pragma unroll
  for (int jt = 0; jt < kStages - 1; ++jt) {
    if (jt < nk) load_tile(jt);
    cp_async_commit();
  }

  // q * (1 / sqrt(D)), computed in float32 and rounded to bf16 here, as it
  // is stored into shared memory; rows past Tq are zeros
  for (int i = tid; i < kBQ * T::UNITS; i += kThreads) {
    const int r = i / T::UNITS;
    const int u = i % T::UNITS;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Tq) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          qb + (long long)(q0 + r) * sq.t + u * 8));
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* y = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x[e]);
        y[e] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(smem + swizzled<HD>(kBQ, r, u)) = w;
  }

  float s[BK / 2];         // scores, then probabilities: S's fragments
  float o[HD / 2];         // output accumulator: O's fragments
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  // descriptors' constant parts: 8-row groups ROWB * 8 bytes apart;
  // V's 64-column chunks (its N atoms) BK * ROWB bytes apart
  constexpr uint32_t kSBO = 8 * T::ROWB;
  constexpr uint32_t kVLBO = BK * T::ROWB;
  const uint32_t q_wg = sQ + wg * 64 * T::ROWB;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j landed
    fence_proxy_async();
    // every thread's copies of tile j landed, and both warpgroups are done
    // with tile j - 1, whose stage the next copies overwrite
    __syncthreads();
    if (j + kStages - 1 < nk) load_tile(j + kStages - 1);
    cp_async_commit();
    const uint32_t sK = ring + (j % kStages) * R::STAGE_BYTES;
    const uint32_t sV = sK + T::KV_BYTES;
    const int k0 = j * BK;

    // S = q K^T: D / 16 steps of 16 along the head dim
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t chunk = kk / T::KSTEPS_ROW;
      const uint32_t within = (kk % T::KSTEPS_ROW) * 32;
      wgmma_ss<BK>(s,
                   desc<HD>(q_wg + chunk * kBQ * T::ROWB + within, 16, kSBO),
                   desc<HD>(sK + chunk * BK * T::ROWB + within, 16, kSBO),
                   kk > 0);
    }
    wgmma_commit();

    // the bias of this thread's fragment elements, read while S runs: from
    // the ring, or straight from device memory
    float bv[BK / 2];
    if constexpr (kBias) {
      const uint8_t* sB = smem + (sK + 2 * T::KV_BYTES - smem0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row1 : row0;
        const BE* br = biasb + (long long)row * sb.t;
        const uint8_t* sr =
            sB + (bias_mode == kOneRow ? 0 : (row - q0) * R::BIAS_LD);
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const int cl = jj * 8 + c0;  // key within the tile
          const int col = k0 + cl;
          const int i = 4 * jj + 2 * half;
          float2 x = make_float2(0.f, 0.f);
          if (bias_mode != kDirect) {
            x = load_pair<BE>(sr + cl * (int)sizeof(BE));
          } else if (row < Tq) {
            if (col < Tk) x.x = to_float(br[col]);
            if (col + 1 < Tk) x.y = to_float(br[col + 1]);
          }
          bv[i] = x.x;
          bv[i + 1] = x.y;
        }
      }
    }

    wgmma_wait_all();
    fence_regs(s);

    // bias, mask, online softmax; fragment i holds row (i / 2) % 2 and key
    // k0 + (i / 4) * 8 + c0 + i % 2. Keys past Tk (in the last tile) go to
    // -inf. Row maxima and sums are taken in four partials a row, so that
    // no chain of dependent operations is longer than BK / 16.
    float mp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) mp[r][q] = -INFINITY;
    const bool ragged = k0 + BK > Tk;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + c0 + (i % 2);
      float x = s[i];
      if constexpr (kBias) x += bv[i];
      if (ragged && col >= Tk) x = -INFINITY;
      s[i] = x;
      mp[(i / 2) % 2][(i / 4) % 4] = fmaxf(mp[(i / 2) % 2][(i / 4) % 4], x);
    }
    float mx[2];
    float alpha[2];
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // all scores so far -inf: subtract 0, so that exp gives 0, not NaN
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2((m_run[r] - m_use[r]) * kLog2e);
      m_run[r] = m_new;
    }
    float lp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      // the difference first: a score equal to the maximum gives exactly 1
      // even at the mask constants' magnitude (1e30)
      const float p = ex2((s[i] - m_use[r]) * kLog2e);
      s[i] = p;
      lp[r][(i / 4) % 4] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] +
                 ((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
    }
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V: BK / 16 steps of 16 keys; P's fragments of keys
    // [16 kk, 16 kk + 16) are S's accumulators 8 kk .. 8 kk + 7, which is
    // the register layout of wgmma's A operand
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[8 * kk + 0], s[8 * kk + 1]),
          pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
          pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
          pack_bf16(s[8 * kk + 6], s[8 * kk + 7]),
      };
      wgmma_rs<HD>(o, a, desc<HD>(sV + kk * 16 * T::ROWB, kVLBO, kSBO));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  bf16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r ? row1 : row0;
    if (row >= Tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = ob + (long long)row * so.t;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(orow + jj * 8 + c0) =
          pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    }
  }
}

template <int HD, typename BT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int Tq, int Tk, const Strides* st,
           int bias_mode, cudaStream_t stream) {
  constexpr int bytes =
      Ring<HD, std::is_same<BT, NoBias>::value ? 0 : (int)sizeof(BT)>::SMEM;
  static unsigned long long opted_in = 0;
  const int err = opt_in_smem(kernel<HD, BT>, bytes, &opted_in);
  if (err != 0) return err;
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return -1;
  kernel<HD, BT><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out, H,
      Tq, Tk, n_qt, st[0], st[1], st[2], st[3], st[4], bias_mode,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename BT>
int launch_d(const void* q, const void* k, const void* v, const void* bias,
             void* out, int B, int H, int Tq, int Tk, int D,
             const Strides* st, int mode, cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, BT>(q, k, v, bias, out, B, H, Tq, Tk, st, mode, s);
    case 64: return launch<64, BT>(q, k, v, bias, out, B, H, Tq, Tk, st, mode, s);
    case 128: return launch<128, BT>(q, k, v, bias, out, B, H, Tq, Tk, st, mode, s);
    default: return -1;
  }
}

}  // namespace tc

}  // namespace

// q (B, H, Tq, D), k and v (B, H, Tk, D), out (B, H, Tq, D): any strides on
// the first three axes (`strides` holds 15 values: b, h, t of q, k, v, bias
// and out), unit stride along D, rows 16-byte aligned. bias: null, or read
// as bias[b * sb + h * sh + row * st + col], broadcast axes with stride 0.
// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); bias_dtype the same codes, float32 only for a float32 q (ignored
// without a bias). Returns cudaGetLastError() of the launch, or -1 for a
// shape or type the kernel does not take.
extern "C" int sb_flash_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int H,
                                  int Tq, int Tk, int D,
                                  const long long* strides, int dtype,
                                  int bias_dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return -1;
  Strides st[5];
  for (int i = 0; i < 5; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bias != nullptr && bias_dtype != 0 && bias_dtype != 1) return -1;
  if (dtype == 0) {
    if (bias != nullptr && bias_dtype == 1) return -1;  // float32 bias only
    switch (D) {
      case 32: return core::launch<32>(q, k, v, bias, out, B, H, Tq, Tk, st, s);
      case 64: return core::launch<64>(q, k, v, bias, out, B, H, Tq, Tk, st, s);
      case 128: return core::launch<128>(q, k, v, bias, out, B, H, Tq, Tk, st, s);
      default: return -1;
    }
  }
  if (dtype != 1) return -1;
  if (bias == nullptr) {
    return tc::launch_d<tc::NoBias>(q, k, v, nullptr, out, B, H, Tq, Tk, D,
                                    st, tc::kDirect, s);
  }
  // the bias goes through the ring where every row of it starts 16-byte
  // aligned and Tk of it fill whole 16-byte chunks; else each thread reads
  // its own elements from device memory
  const long long esize = bias_dtype == 1 ? 2 : 4;
  const Strides& sb = st[3];
  const bool rows16 = (uintptr_t)bias % 16 == 0 && sb.b * esize % 16 == 0 &&
                      sb.h * esize % 16 == 0 && sb.t * esize % 16 == 0 &&
                      Tk * esize % 16 == 0;
  const int mode = !rows16 ? tc::kDirect
                 : sb.t == 0 ? tc::kOneRow : tc::kTileRows;
  return bias_dtype == 1
      ? tc::launch_d<__nv_bfloat16>(q, k, v, bias, out, B, H, Tq, Tk, D, st,
                                    mode, s)
      : tc::launch_d<float>(q, k, v, bias, out, B, H, Tq, Tk, D, st, mode, s);
}
