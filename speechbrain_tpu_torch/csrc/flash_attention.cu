// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D) + bias) v
// with an online softmax; the (Tq, Tk) scores never reach device memory.
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/attention.py
// (flash_attention / _flash_kernel / _no_bias_kernel). The TPU kernel pads
// Tq and Tk to 128 with copies of q, k, v and the bias (padding biased by
// NEG_INF / 2), reshapes the bias to (B*H, Tq, Tk) and walks 128-key blocks
// in a sequential loop. Here nothing is padded or copied:
//
// - A block of 256 threads owns one (batch, head) and a tile of 64 query
//   rows. It stages q * (1 / sqrt(D)) (scaled first, as the TPU kernel does)
//   and then each 64-key tile of K and V in shared memory as float32, rows
//   past Tq or Tk filled with zeros.
// - Thread (ty, tx) of a 16 x 16 grid holds the scores of rows ty + 16 i and
//   keys tx + 16 j (i, j < 4) in registers; a key past Tk is masked by its
//   index to -inf. The bias is read in place through its own strides, with
//   stride 0 on the axes it is broadcast along, so the shapes (Tq, Tk),
//   (B, 1, 1, Tk), (1, 1, Tq, Tk) and (B, H, Tq, Tk) all run as they are.
// - The running maximum, denominator and the output rows ty + 16 i, columns
//   tx * D/16 ... are kept in float32 registers; row maxima and sums are
//   reduced by shuffles across the 16 lanes that share a row, and the tile's
//   probabilities pass through shared memory for the P V product.
// - A row whose every score is -inf keeps a zero denominator and is written
//   as zeros; with the finite mask constants of both packages (-1e9, -1e30)
//   no score is -inf, and the maximum stays finite.
//
// Bound: operations, for this kernel. A launch does 4 * B * H * Tq * Tk * D
// flops on B * H * (2 Tq + 2 Tk) * D elements read or written, i.e. about
// Tk / 2 flops a byte in bf16 for self-attention: far above the float32
// CUDA-core ridge (20 flops a byte) that this first version works against,
// since it multiplies on the CUDA cores in float32 (no mma.sync / wgmma, no
// TMA, no overlap of loads and products). On the bf16 tensor cores (ridge
// near 295) a sequence of 256 keys would be bound by its bytes and one of
// 1024 by its operations; reaching either is a later change's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
static_assert(kBQ == kBK, "load_tile stages kBK rows of q as of k and v");
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = 4;        // floats of padding a shared-memory row

struct Strides {
  long long b, h, t;  // elements; the last axis has unit stride
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements in 16 bytes
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
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
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Rows [r0, r0 + 64) of a (n, HD) matrix with row stride `st`, times `mul`,
// into shared memory with row stride HD + kPad; rows >= n become zeros.
template <typename T, int HD>
__device__ void load_tile(const T* __restrict__ base, long long st, int r0,
                          int n, float mul, float* __restrict__ s) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int CPR = HD / VEC;  // 16-byte chunks a row
  constexpr int LD = HD + kPad;
  for (int c = threadIdx.x; c < kBK * CPR; c += kThreads) {
    const int r = c / CPR;
    const int d = (c % CPR) * VEC;
    float f[VEC];
    if (r0 + r < n) {
      Elem<T>::load(base + (long long)(r0 + r) * st + d, f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s + r * LD + d);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      dst[i] = make_float4(f[4 * i] * mul, f[4 * i + 1] * mul,
                           f[4 * i + 2] * mul, f[4 * i + 3] * mul);
    }
  }
}

template <typename T, typename BT, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const BT* __restrict__ bias,
                       T* __restrict__ out, int H, int Tq, int Tk, int n_qt,
                       Strides sq, Strides sk, Strides sv, Strides sb,
                       Strides so, float scale) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const BT* biasb = bias == nullptr ? nullptr : bias + b * sb.b + h * sb.h;

  load_tile<T, HD>(qb, sq.t, q0, Tq, scale, sQ);

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
    load_tile<T, HD>(kb, sk.t, k0, Tk, 1.f, sK);
    load_tile<T, HD>(vb, sv.t, k0, Tk, 1.f, sV);
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
          s[i][j] += Elem<BT>::to_float(biasb[(long long)row * sb.t + col]);
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

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ob[(long long)row * so.t + c0 + c] = Elem<T>::from_float(acc[i][c] * inv);
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) *
         (kBQ * (HD + kPad) + 2 * kBK * (HD + kPad) + kBQ * (kBK + kPad));
}

template <typename T, typename BT, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* bias,
              void* out, int B, int H, int Tq, int Tk, const Strides* st,
              cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  // above 48 KB of dynamic shared memory only after an opt-in, made once
  // for each device this instantiation runs on (so never while a CUDA graph
  // is being captured, once a call has run outside one)
  static unsigned long long opted_in = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return -1;
  if (!(opted_in >> device & 1ULL)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, BT, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1ULL << device;
  }
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return -1;
  flash_attention_kernel<T, BT, HD><<<(unsigned)blocks, kThreads, bytes,
                                      stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const BT*)bias, (T*)out, H, Tq,
      Tk, n_qt, st[0], st[1], st[2], st[3], st[4],
      1.0f / sqrtf((float)(HD)));
  return (int)cudaGetLastError();
}

template <typename T, typename BT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int Tq, int Tk, int D, const Strides* st,
           cudaStream_t stream) {
  switch (D) {
    case 32: return launch_hd<T, BT, 32>(q, k, v, bias, out, B, H, Tq, Tk, st, stream);
    case 64: return launch_hd<T, BT, 64>(q, k, v, bias, out, B, H, Tq, Tk, st, stream);
    case 128: return launch_hd<T, BT, 128>(q, k, v, bias, out, B, H, Tq, Tk, st, stream);
    default: return -1;
  }
}

}  // namespace

// q (B, H, Tq, D), k and v (B, H, Tk, D), out (B, H, Tq, D): any strides on
// the first three axes (`strides` holds 15 values: b, h, t of q, k, v, bias
// and out), unit stride along D, rows 16-byte aligned. bias: null, or read
// as bias[b * sb + h * sh + row * st + col], broadcast axes with stride 0.
// dtype: 0 = float32, 1 = bfloat16; bias_dtype the same codes, float32
// only for a float32 q (ignored without a bias). Returns cudaGetLastError()
// of the launch, or -1 for a shape or type the kernel does not take.
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
  const bool bias_bf16 = bias != nullptr && bias_dtype == 1;
  if (bias != nullptr && bias_dtype != 0 && bias_dtype != 1) return -1;
  if (dtype == 0) {
    if (bias_bf16) return -1;  // a float32 q takes a float32 bias only
    return launch<float, float>(q, k, v, bias, out, B, H, Tq, Tk, D, st, s);
  }
  if (dtype == 1) {
    return bias_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, bias, out, B, H, Tq, Tk, D, st, s)
        : launch<__nv_bfloat16, float>(q, k, v, bias, out, B, H, Tq, Tk, D, st, s);
  }
  return -1;
}
