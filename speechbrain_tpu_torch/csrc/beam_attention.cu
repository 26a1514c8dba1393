// Ancestry beam attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/beam_attention.py
// (_ancestry_attention_pallas / _kernel). Computes, for every hypothesis
// (b, h) and head, single-query attention over the hypothesis' own history
// read through the ancestry table:
//
//   k_g[t] = k_cache[b, anc[b, h, t], t, head*hd : (head+1)*hd]
//   out    = softmax_t(q . k_g[t] / sqrt(hd), t <= step) . v_g
//
// The TPU kernel forms all K x K pair scores on the matrix unit and selects
// with a one-hot mask because that machine cannot gather; here a block owns
// one (b, h, head) and gathers each K/V row it needs directly (hd
// contiguous values, 16-byte loads). Nothing is padded or copied, and any
// cache length L is taken.
//
// What bounds it. A launch reads at most 2*B*K*(step+1)*D*itemsize bytes
// of K/V (less where hypotheses share an ancestor's row) and does 4 flops
// per element read, far below the card's operations-per-byte ridge: bound
// by bytes. At the main path's shapes (batch 8, beam 10, at most 52
// positions: a few megabytes) the bytes take a couple of microseconds, and
// a launch also pays a floor of its own: the launch, then two dependent
// memory latencies (the ancestry entries, then the K/V rows they point to),
// about half of a launch at step 50. At the published decode's shape (beam
// 66, 288 positions, about 300 MB at random ancestry) the bytes dominate.
//
// The design, for both:
// - The ancestry entries of positions 0..step are loaded once, into shared
//   memory, up front, with one coalesced load (up to 1024 at a time; longer
//   histories take further rounds), before any K/V address is formed. Each
//   of the H blocks of a hypothesis loads them for itself: they are at most
//   a few kilobytes, and the second to H-th reads hit L2.
// - Then the K/V loads of many positions are issued before any is
//   consumed: a group of hd/VEC lanes takes one position (VEC = 16 bytes of
//   the type), the block's 128 threads hold G = 128 / (hd/VEC) groups, and
//   each group loads kUnroll = 4 positions a batch into registers. So 4G
//   positions (64 at hd 64 in bf16) are in flight at once: at step 50 all
//   51 of them, in one wave of loads. A long history (the beam-66 shape: 288
//   positions, 4.5 batches) keeps loads flowing through the other blocks of
//   the SM while one block works on a batch. Registers, not a cp.async
//   ring in shared memory: the loads land where the arithmetic needs them,
//   and at 64 registers a thread 8 blocks fit an SM. (Two positions a group
//   with the next batch's loads issued before this batch's arithmetic was
//   slower at every shape measured.) TMA is not the tool for this: it has
//   no gather on Hopper, and each position's row comes from a different
//   cache row.
// - Each group keeps a running maximum, denominator and fp32 accumulator in
//   registers; the groups are merged once through shared memory. Every
//   thread runs the same number of trips, so the shuffles that sum a
//   position's partial dot products are always executed by whole warps.
// - The grid stays one block per (b, h, head): 640 and 960 blocks at the
//   main path's shapes (4.8 and 7.3 an SM, so one wave of 8 blocks an SM
//   holds them all), 6336 at beam 66. One block a hypothesis for all heads
//   would be 80 blocks on 132 SMs; two heads a block (half the blocks, one
//   ancestry load for both) was slower; splitting positions across blocks
//   would need a merge between them and buys nothing while there are
//   several blocks an SM.
//
// Other head dims. The fast path above wants a power-of-two number of
// 16-byte lanes a position, which holds for head dims 32, 64 and 128 (the
// main path's decoder and LM, and transformer.yaml's decoder); the TPU
// kernel takes any head dim. Every other head dim up to kMaxHeadDim goes to
// ancestry_attention_any_kernel: a warp takes a position and its 32 lanes
// split the head's row into vectors of VB bytes, the widest of 16, 8, 4 and
// 2 that divides the row's bytes (so that every head's offset is aligned as
// well: head dim 18 loads 4-byte bf16x2 pairs in bfloat16 and 8-byte pairs
// in float32); lanes past the row load nothing and add zero, and the dot
// product is summed over the whole warp, so the shuffles never depend on
// the head dim. Four warps hold kAnyUnroll positions each in flight, 16 a
// batch. It is simple and right first; its time at head dim 18 is in
// PERF.md.
//
// What a later change could still take: the decode loop issues 18 of these
// launches a step from Python, and each eager call costs the host several
// times the kernel's device time; capturing a decode step in a CUDA graph
// takes that away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;    // blocks an SM: at most 64 registers a thread
constexpr int kUnroll = 4;       // positions a lane group loads a batch
constexpr int kAncChunk = 1024;  // ancestry entries staged at a time

template <typename T>
struct Vec16;  // 16 bytes of T, widened to float

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
  __device__ static float to(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 to(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Issues the K/V loads of this lane's slice of positions p0 + g + G*u
// (u < kUnroll) of the staged chunk, those below n.
template <typename T, int G>
__device__ __forceinline__ void issue_loads(
    const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* s_anc, size_t row0, int L, int D, int d0, int c0, int p0,
    int g, int n, uint4 (&kr)[kUnroll], uint4 (&vr)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = p0 + g + G * u;
    if (i < n) {
      const size_t off =
          ((row0 + s_anc[i]) * (size_t)L + (size_t)(c0 + i)) * D + d0;
      kr[u] = load16(k_cache + off);
      vr[u] = load16(v_cache + off);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ancestry_attention_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_cache,
                          const T* __restrict__ v_cache,
                          const int* __restrict__ anc,
                          T* __restrict__ out,
                          int K, int L, int H, int step, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LP = HD / VEC;       // lanes that share one position
  constexpr int G = kThreads / LP;   // position groups a block
  constexpr int P = G * kUnroll;     // positions a batch
  static_assert(LP >= 1 && LP <= 32 && (LP & (LP - 1)) == 0, "bad head dim");
  static_assert(kAncChunk % P == 0, "a chunk holds whole batches");

  __shared__ int s_anc[kAncChunk];
  __shared__ float s_m[G];
  __shared__ float s_l[G];
  __shared__ float s_acc[G * HD];

  const int D = H * HD;
  const int head = blockIdx.x % H;
  const int bh = blockIdx.x / H;     // b * K + h
  const int b = bh / K;
  const int g = threadIdx.x / LP;
  const int lane = threadIdx.x % LP;
  const int d0 = head * HD + lane * VEC;
  const int* anc_row = anc + (size_t)bh * L;
  const size_t row0 = (size_t)b * K;

  float qf[VEC];
  Vec16<T>::widen(load16(q + (size_t)bh * D + d0), qf);
#pragma unroll
  for (int i = 0; i < VEC; ++i) qf[i] *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 <= step; c0 += kAncChunk) {
    const int n = min(step + 1 - c0, kAncChunk);  // positions of this chunk
    if (c0 > 0) __syncthreads();  // the last chunk's readers are done
    // the chunk's ancestry entries, one coalesced load, before any K/V
    // address is formed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_anc[i] = __ldg(anc_row + c0 + i);
    }
    __syncthreads();

    uint4 kc[kUnroll], vc[kUnroll];
    // every thread runs the same number of trips, so the shuffles below
    // are always executed by whole warps
    for (int p0 = 0; p0 < n; p0 += P) {
      issue_loads<T, G>(k_cache, v_cache, s_anc, row0, L, D, d0, c0, p0, g,
                        n, kc, vc);
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC];
        Vec16<T>::widen(kc[u], kf);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qf[i], kf[i], s);
        sc[u] = s;
      }
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
        }
      }
      // positions p0 + g + G*u rise with u: a group whose first is past
      // the chunk has none in this batch
      if (p0 + g < n) {
        float mb = sc[0];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) {
          if (p0 + g + G * u < n) mb = fmaxf(mb, sc[u]);
        }
        const float m_new = fmaxf(m, mb);
        const float corr = expf(m - m_new);  // exp(-inf) = 0 on the first
        l *= corr;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p0 + g + G * u < n) {
            const float p = expf(sc[u] - m_new);
            float vf[VEC];
            Vec16<T>::widen(vc[u], vf);
            l += p;
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
          }
        }
        m = m_new;
      }
    }
  }

  if (lane == 0) {
    s_m[g] = m;
    s_l[g] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) s_acc[g * HD + lane * VEC + i] = acc[i];
  __syncthreads();

  if (threadIdx.x < HD) {
    const int d = threadIdx.x;
    float m_all = -INFINITY;
#pragma unroll
    for (int j = 0; j < G; ++j) m_all = fmaxf(m_all, s_m[j]);
    float l_all = 0.f;
    float o_all = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      // a group that saw no position has m = -inf and weighs nothing;
      // position 0 is always valid, so m_all is finite
      const float w = expf(s_m[j] - m_all);
      l_all = fmaf(s_l[j], w, l_all);
      o_all = fmaf(s_acc[j * HD + d], w, o_all);
    }
    out[(size_t)bh * D + head * HD + d] = Vec16<T>::to(o_all / l_all);
  }
}

// -- any head dim up to kMaxHeadDim ---------------------------------------

constexpr int kMaxHeadDim = 256;
constexpr int kAnyWarps = kThreads / 32;
constexpr int kAnyUnroll = 4;           // positions a warp loads a batch
constexpr int kAnyLaneElems = kMaxHeadDim / 32;  // elements a lane at most

template <int VB>
struct Raw;  // an unsigned type of VB bytes
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// E = VB / sizeof(T) values of T read as one VB-byte load, widened
template <typename T, int VB>
__device__ __forceinline__ void widen_any(
    const typename Raw<VB>::type& r, float* out) {
  constexpr int E = VB / (int)sizeof(T);
  const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_float(t[e]);
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
ancestry_attention_any_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_cache,
                              const T* __restrict__ v_cache,
                              const int* __restrict__ anc,
                              T* __restrict__ out,
                              int K, int L, int H, int HD, int step,
                              float scale) {
  constexpr int E = VB / (int)sizeof(T);  // values a vector
  constexpr int NV = kAnyLaneElems / E;   // vectors a lane at most
  constexpr int P = kAnyWarps * kAnyUnroll;  // positions a batch
  static_assert(E >= 1 && NV >= 1, "bad vector width");
  static_assert(kAncChunk % P == 0, "a chunk holds whole batches");
  using R = typename Raw<VB>::type;

  __shared__ int s_anc[kAncChunk];
  __shared__ float s_m[kAnyWarps];
  __shared__ float s_l[kAnyWarps];
  __shared__ float s_acc[kAnyWarps * kMaxHeadDim];

  const int D = H * HD;
  const int head = blockIdx.x % H;
  const int bh = blockIdx.x / H;     // b * K + h
  const int b = bh / K;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvec = HD / E;           // vectors a row
  const int d_head = head * HD;
  const int* anc_row = anc + (size_t)bh * L;
  const size_t row0 = (size_t)b * K;

  // this lane's vectors of the row are lane + 32 j; those past the row
  // hold zeros and are never loaded
  float qf[NV][E];
  float acc[NV][E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lane + 32 * j;
    if (vi < nvec) {
      const R r = __ldg(reinterpret_cast<const R*>(
          q + (size_t)bh * D + d_head + vi * E));
      widen_any<T, VB>(r, qf[j]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qf[j][e] *= scale;
      acc[j][e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int c0 = 0; c0 <= step; c0 += kAncChunk) {
    const int n = min(step + 1 - c0, kAncChunk);  // positions of this chunk
    if (c0 > 0) __syncthreads();  // the last chunk's readers are done
    for (int i = threadIdx.x; i < n; i += kThreads) {
      s_anc[i] = __ldg(anc_row + c0 + i);
    }
    __syncthreads();

    // every warp runs the same number of trips; the shuffles below are
    // executed by whole warps
    for (int p0 = 0; p0 < n; p0 += P) {
      R kr[kAnyUnroll][NV], vr[kAnyUnroll][NV];
#pragma unroll
      for (int u = 0; u < kAnyUnroll; ++u) {
        const int i = p0 + warp + kAnyWarps * u;
        if (i < n) {
          const size_t off =
              ((row0 + s_anc[i]) * (size_t)L + (size_t)(c0 + i)) * D +
              d_head;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int vi = lane + 32 * j;
            if (vi < nvec) {
              kr[u][j] = __ldg(reinterpret_cast<const R*>(
                  k_cache + off + vi * E));
              vr[u][j] = __ldg(reinterpret_cast<const R*>(
                  v_cache + off + vi * E));
            }
          }
        }
      }
      float sc[kAnyUnroll];
#pragma unroll
      for (int u = 0; u < kAnyUnroll; ++u) {
        float s = 0.f;
        if (p0 + warp + kAnyWarps * u < n) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            if (lane + 32 * j < nvec) {
              float kf[E];
              widen_any<T, VB>(kr[u][j], kf);
#pragma unroll
              for (int e = 0; e < E; ++e) s = fmaf(qf[j][e], kf[e], s);
            }
          }
        }
        sc[u] = s;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kAnyUnroll; ++u) {
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
        }
      }
      // positions p0 + warp + kAnyWarps u rise with u: a warp whose first
      // is past the chunk has none in this batch
      if (p0 + warp < n) {
        float mb = sc[0];
#pragma unroll
        for (int u = 1; u < kAnyUnroll; ++u) {
          if (p0 + warp + kAnyWarps * u < n) mb = fmaxf(mb, sc[u]);
        }
        const float m_new = fmaxf(m, mb);
        const float corr = expf(m - m_new);  // exp(-inf) = 0 on the first
        l *= corr;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] *= corr;
        }
#pragma unroll
        for (int u = 0; u < kAnyUnroll; ++u) {
          if (p0 + warp + kAnyWarps * u < n) {
            const float p = expf(sc[u] - m_new);
            l += p;
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              if (lane + 32 * j < nvec) {
                float vf[E];
                widen_any<T, VB>(vr[u][j], vf);
#pragma unroll
                for (int e = 0; e < E; ++e) {
                  acc[j][e] = fmaf(p, vf[e], acc[j][e]);
                }
              }
            }
          }
        }
        m = m_new;
      }
    }
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lane + 32 * j;
    if (vi < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s_acc[warp * kMaxHeadDim + vi * E + e] = acc[j][e];
      }
    }
  }
  __syncthreads();

  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kAnyWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
    float l_all = 0.f;
    float o_all = 0.f;
#pragma unroll
    for (int w = 0; w < kAnyWarps; ++w) {
      // a warp that saw no position has m = -inf and weighs nothing;
      // position 0 is always valid, so m_all is finite
      const float wt = expf(s_m[w] - m_all);
      l_all = fmaf(s_l[w], wt, l_all);
      o_all = fmaf(s_acc[w * kMaxHeadDim + d], wt, o_all);
    }
    out[(size_t)bh * D + d_head + d] = Vec16<T>::to(o_all / l_all);
  }
}

// the widest of 16, 8, 4, 2 bytes that divides a row of hd values of T,
// and so every head's offset too; at least one value of T
template <typename T>
int vector_bytes(int hd) {
  const int bytes = hd * (int)sizeof(T);
  for (int vb = 16; vb > (int)sizeof(T); vb /= 2) {
    if (bytes % vb == 0) return vb;
  }
  return (int)sizeof(T);
}

template <typename T, int VB>
int launch_any(const void* q, const void* k, const void* v, const void* anc,
               void* out, int B, int K, int L, int H, int hd, int step,
               float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * K * H));
  ancestry_attention_any_kernel<T, VB><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)anc, (T*)out, K, L,
      H, hd, step, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any_width(const void* q, const void* k, const void* v,
                     const void* anc, void* out, int B, int K, int L, int H,
                     int hd, int step, float scale, cudaStream_t stream);

template <>
int launch_any_width<float>(const void* q, const void* k, const void* v,
                            const void* anc, void* out, int B, int K, int L,
                            int H, int hd, int step, float scale,
                            cudaStream_t stream) {
  switch (vector_bytes<float>(hd)) {
    case 16: return launch_any<float, 16>(q, k, v, anc, out, B, K, L, H, hd,
                                          step, scale, stream);
    case 8: return launch_any<float, 8>(q, k, v, anc, out, B, K, L, H, hd,
                                        step, scale, stream);
    default: return launch_any<float, 4>(q, k, v, anc, out, B, K, L, H, hd,
                                         step, scale, stream);
  }
}

template <>
int launch_any_width<__nv_bfloat16>(const void* q, const void* k,
                                    const void* v, const void* anc, void* out,
                                    int B, int K, int L, int H, int hd,
                                    int step, float scale,
                                    cudaStream_t stream) {
  using bf = __nv_bfloat16;
  switch (vector_bytes<bf>(hd)) {
    case 16: return launch_any<bf, 16>(q, k, v, anc, out, B, K, L, H, hd,
                                       step, scale, stream);
    case 8: return launch_any<bf, 8>(q, k, v, anc, out, B, K, L, H, hd, step,
                                     scale, stream);
    case 4: return launch_any<bf, 4>(q, k, v, anc, out, B, K, L, H, hd, step,
                                     scale, stream);
    default: return launch_any<bf, 2>(q, k, v, anc, out, B, K, L, H, hd,
                                      step, scale, stream);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* anc,
           void* out, int B, int K, int L, int H, int hd, int step,
           cudaStream_t stream) {
  const dim3 grid((unsigned)(B * K * H));
  const float scale = 1.0f / sqrtf((float)hd);
#define SB_LAUNCH(HD)                                                        \
  ancestry_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(           \
      (const T*)q, (const T*)k, (const T*)v, (const int*)anc, (T*)out, K, L, \
      H, step, scale)
  switch (hd) {
    case 32: SB_LAUNCH(32); break;
    case 64: SB_LAUNCH(64); break;
    case 128: SB_LAUNCH(128); break;
    default:
      if (hd < 1 || hd > kMaxHeadDim) return -1;
      return launch_any_width<T>(q, k, v, anc, out, B, K, L, H, hd, step,
                                 scale, stream);
  }
#undef SB_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch,
// or -1 for a shape or type the kernel does not take.
extern "C" int sb_ancestry_attention(const void* q, const void* k_cache,
                                     const void* v_cache, const void* anc,
                                     void* out, int B, int K, int L, int H,
                                     int hd, int step, int dtype,
                                     void* stream) {
  if (B <= 0 || K <= 0 || L <= 0 || H <= 0 || step < 0 || step >= L) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(q, k_cache, v_cache, anc, out, B, K, L, H, hd, step, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_cache, v_cache, anc, out, B, K, L, H, hd,
                                 step, s);
  }
  return -1;
}
