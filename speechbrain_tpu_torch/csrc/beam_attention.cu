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
// one (b, h, head), loads its own ancestry entries and reads each K/V row
// directly (hd contiguous values, 16-byte loads). Positions t <= step are
// spread over groups of hd/VEC lanes; each group keeps a running maximum,
// denominator and fp32 accumulator in registers, and the groups are merged
// once through shared memory. Nothing is padded or copied, any cache length
// L is taken.
//
// Bound: bytes. A launch reads about 2*B*K*(step+1)*D*itemsize bytes of K/V
// and does 4 flops per element read, far below the card's operations-per-byte
// ridge. At beam-search shapes the bytes are so few (around a megabyte at
// batch 8, beam 10, 52 positions) that one launch costs about as much as its
// launch latency: a decode of S steps over N layers issues S*N such launches,
// so the loop is launch-latency bound until it is captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Vec16;  // one 16-byte vector of T, widened to float

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float to(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 to(float x) { return __float2bfloat16(x); }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ancestry_attention_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_cache,
                          const T* __restrict__ v_cache,
                          const int* __restrict__ anc,
                          T* __restrict__ out,
                          int K, int L, int H, int step, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int LP = HD / VEC;       // lanes that share one position
  constexpr int G = kThreads / LP;   // positions in flight per block
  static_assert(LP >= 1 && LP <= 32 && (LP & (LP - 1)) == 0, "bad head dim");

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

  float qf[VEC];
  Vec16<T>::load(q + (size_t)bh * D + d0, qf);
#pragma unroll
  for (int i = 0; i < VEC; ++i) qf[i] *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  const int* anc_row = anc + (size_t)bh * L;
  const size_t row0 = (size_t)b * K;
  // every thread runs the same number of trips, so the shuffles below are
  // always executed by whole warps
  for (int t0 = 0; t0 <= step; t0 += G) {
    const int t = t0 + g;
    const bool valid = t <= step;
    float s = 0.f;
    float vf[VEC];
    if (valid) {
      const int src = anc_row[t];
      const size_t off = ((row0 + src) * L + t) * D + d0;
      float kf[VEC];
      Vec16<T>::load(k_cache + off, kf);
      Vec16<T>::load(v_cache + off, vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(qf[i], kf[i], s);
    }
#pragma unroll
    for (int o = LP / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (valid) {
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);   // exp(-inf) = 0 on the first trip
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i] * corr);
      m = m_new;
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
    default: return -1;
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
