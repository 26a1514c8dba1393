// Fused log-mel front end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of speechbrain_tpu/ops/mel_frontend.py
// (fused_fbank / _mel_kernel): waveform -> centred frames -> window-folded
// real DFT -> power -> mel projection -> dB, in one pass, so neither the
// frames nor the power spectrum reach device memory.
//
// A block takes a tile of kFrameTile frames of one utterance. It reads the
// tile's span of the waveform into shared memory once; the zero padding of
// the centred STFT is made by masking the index, not by a padded copy.
// Thread k then accumulates re/im of frequency k for all frames of the tile
// against the window-folded cos/sin tables (read through L2, shared by all
// blocks), the power tile goes to shared memory, and the threads project it
// through the mel matrix, take the log and write (frames, n_mels). None of
// the TPU kernel's 128-lane padding, phase-grouped rolls or separate tail
// input is needed here. The per-sequence top_db clamp needs a maximum over
// all frames and stays outside, on the small output.
//
// Bound: operations. FLOPs ~ B*n_frames*(2*2*n_fft*n_freq + 2*n_freq*n_mels)
// against B*T*4 + B*n_frames*n_mels*4 bytes: about 350 flops a byte at
// n_fft 400 / hop 160 / 80 mels, above the fp32 ridge of the card. This is a
// plain shared-memory FMA loop on the CUDA cores; the tensor cores are left
// for a later version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrameTile = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_fbank_kernel(const float* __restrict__ wav,
                   const float* __restrict__ cos_m,
                   const float* __restrict__ sin_m,
                   const float* __restrict__ mel_m,
                   float* __restrict__ out,
                   int T, int n_frames, int n_fft, int n_freq, int n_mels,
                   int hop, float amin, float multiplier, float db_offset) {
  extern __shared__ float smem[];
  const int span = (kFrameTile - 1) * hop + n_fft;
  float* s_wav = smem;          // span
  float* s_pow = smem + span;   // kFrameTile * n_freq

  const int tiles = (n_frames + kFrameTile - 1) / kFrameTile;
  const int b = blockIdx.x / tiles;
  const int f0 = (blockIdx.x % tiles) * kFrameTile;
  const long long start = (long long)f0 * hop - n_fft / 2;
  const float* wav_b = wav + (size_t)b * T;

  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long p = start + i;
    s_wav[i] = (p >= 0 && p < T) ? wav_b[p] : 0.f;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_freq; k += kThreads) {
    float re[kFrameTile];
    float im[kFrameTile];
#pragma unroll
    for (int f = 0; f < kFrameTile; ++f) {
      re[f] = 0.f;
      im[f] = 0.f;
    }
    for (int n = 0; n < n_fft; ++n) {
      const float c = cos_m[(size_t)n * n_freq + k];
      const float s = sin_m[(size_t)n * n_freq + k];
#pragma unroll
      for (int f = 0; f < kFrameTile; ++f) {
        const float x = s_wav[f * hop + n];   // same address in the warp
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrameTile; ++f) {
      s_pow[f * n_freq + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kFrameTile * n_mels; o += kThreads) {
    const int f = o / n_mels;
    const int m = o % n_mels;
    const int frame = f0 + f;
    if (frame >= n_frames) continue;
    const float* pw = s_pow + f * n_freq;
    float acc = 0.f;
    for (int k = 0; k < n_freq; ++k) {
      acc = fmaf(pw[k], mel_m[(size_t)k * n_mels + m], acc);
    }
    out[((size_t)b * n_frames + frame) * n_mels + m] =
        multiplier * log10f(fmaxf(acc, amin)) - db_offset;
  }
}

}  // namespace

// Returns cudaGetLastError() of the launch, -1 for sizes the kernel does not
// take, -2 when the tile does not fit the block's shared memory.
extern "C" int sb_fused_fbank(const void* wav, const void* cos_m,
                              const void* sin_m, const void* mel_m, void* out,
                              int B, int T, int n_frames, int n_fft,
                              int n_freq, int n_mels, int hop, float amin,
                              float multiplier, float db_offset,
                              void* stream) {
  if (B <= 0 || T <= 0 || n_frames <= 0 || n_fft <= 0 || n_freq <= 0 ||
      n_mels <= 0 || hop <= 0) {
    return -1;
  }
  const size_t span = (size_t)(kFrameTile - 1) * hop + n_fft;
  const size_t smem = (span + (size_t)kFrameTile * n_freq) * sizeof(float);
  if (smem > 227 * 1024) return -2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (n_frames + kFrameTile - 1) / kFrameTile;
  fused_fbank_kernel<<<(unsigned)(B * tiles), kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)cos_m, (const float*)sin_m,
      (const float*)mel_m, (float*)out, T, n_frames, n_fft, n_freq, n_mels,
      hop, amin, multiplier, db_offset);
  return (int)cudaGetLastError();
}
