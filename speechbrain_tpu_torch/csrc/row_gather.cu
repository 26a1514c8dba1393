// Row gather for Hopper (sm_90a): out[i] = x[idx[i]] along axis 0.
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/gather.py
// (row_gather / _make_kernel), which copies R = 8 rows a grid step by DMA,
// with the row indices delivered through scalar prefetch. Here a row is a
// run of `row_bytes` contiguous bytes of any element type; the kernel copies
// bytes and never looks at their type, so the copy is exact.
//
// Layout of the work: blockIdx.x is the output row, blockIdx.y one of a few
// chunks of it. A block reads its source index once, then its threads copy
// the row's units with neighbouring threads on neighbouring addresses. The
// unit is the widest of 16, 8, 4, 2 or 1 bytes that divides `row_bytes`
// (both base pointers are 16-byte aligned, so every row start is aligned to
// the unit): rows of a multiple of 16 bytes, as every cache row of the beam
// search is, move as 16-byte vector loads and stores; a row of any other size
// moves in the largest unit that fits it, so there is no separate tail.
//
// A bad index: an index outside [0, n_src) is never followed. The output row
// is filled with zero bytes instead, so the kernel never reads outside x.
// (The wrapper does not check the indices on the host: that would cost a
// synchronisation per call.)
//
// Bound: bytes. A launch moves 2 * n_out * row_bytes bytes (each source row
// read once, each output row written once) and computes nothing; in the
// beam search's cache permute that is 5 to 8 MB a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;    // units in flight per thread a pass
constexpr int kMaxChunks = 64;        // blocks that share one output row

template <typename U, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const U* __restrict__ x, const I* __restrict__ idx,
                  U* __restrict__ out, long long n_src, long long units) {
  const long long row = blockIdx.x;
  const long long src = (long long)idx[row];
  U* dst = out + row * units;
  const long long step = (long long)gridDim.y * kThreads;
  long long u = (long long)blockIdx.y * kThreads + threadIdx.x;
  if (src < 0 || src >= n_src) {
    const U zero{};
    for (; u < units; u += step) dst[u] = zero;
    return;
  }
  const U* from = x + src * units;
  // kUnitsPerThread independent loads are issued before their stores
  for (; u + (kUnitsPerThread - 1) * step < units;
       u += kUnitsPerThread * step) {
    U v[kUnitsPerThread];
#pragma unroll
    for (int j = 0; j < kUnitsPerThread; ++j) v[j] = from[u + j * step];
#pragma unroll
    for (int j = 0; j < kUnitsPerThread; ++j) dst[u + j * step] = v[j];
  }
  for (; u < units; u += step) dst[u] = from[u];
}

template <typename U>
int launch(const void* x, const void* idx, int idx_is_64, void* out,
           long long n_out, long long n_src, long long row_bytes,
           cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  long long chunks = (units + (long long)kThreads * kUnitsPerThread - 1) /
                     ((long long)kThreads * kUnitsPerThread);
  if (chunks < 1) chunks = 1;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  const dim3 grid((unsigned)n_out, (unsigned)chunks);
  if (idx_is_64) {
    row_gather_kernel<U, long long><<<grid, kThreads, 0, stream>>>(
        (const U*)x, (const long long*)idx, (U*)out, n_src, units);
  } else {
    row_gather_kernel<U, int><<<grid, kThreads, 0, stream>>>(
        (const U*)x, (const int*)idx, (U*)out, n_src, units);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_src, row_bytes) bytes, idx: (n_out,) int32 or int64 (idx_is_64),
// out: (n_out, row_bytes) bytes; x and out 16-byte aligned. Returns
// cudaGetLastError() of the launch, or -1 for a shape the kernel does not
// take.
extern "C" int sb_row_gather(const void* x, const void* idx, void* out,
                             long long n_out, long long n_src,
                             long long row_bytes, int idx_is_64,
                             void* stream) {
  if (n_out <= 0 || n_out > 0x7fffffffLL || n_src <= 0 || row_bytes <= 0) {
    return -1;
  }
  if (((uintptr_t)x | (uintptr_t)out) % 16) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0) {
    return launch<uint4>(x, idx, idx_is_64, out, n_out, n_src, row_bytes, s);
  }
  if (row_bytes % 8 == 0) {
    return launch<uint2>(x, idx, idx_is_64, out, n_out, n_src, row_bytes, s);
  }
  if (row_bytes % 4 == 0) {
    return launch<uint32_t>(x, idx, idx_is_64, out, n_out, n_src, row_bytes,
                            s);
  }
  if (row_bytes % 2 == 0) {
    return launch<uint16_t>(x, idx, idx_is_64, out, n_out, n_src, row_bytes,
                            s);
  }
  return launch<uint8_t>(x, idx, idx_is_64, out, n_out, n_src, row_bytes, s);
}
