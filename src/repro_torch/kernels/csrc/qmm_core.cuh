// qmm_core.cuh — the split-K dequantize-matmul blocks shared by csrc/qmm.cu
// (kernel B5) and csrc/qmm_qout.cu (kernel B7): one compiled copy of the
// same arithmetic in both libraries, so that qmm_qout's product equals
// qmm's bit for bit (the fused epilogue then equals qmm → cast → encode).
// The design notes are in qmm.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 8;      // rows of x per block
constexpr int kKSub = 128;  // k rows of x staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool PACKED>
__device__ __forceinline__ void decode_word(uint32_t word, float* w) {
  if (PACKED) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      w[c] = static_cast<float>(static_cast<int>((word >> (4 * c)) & 0xFu) - 8);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = static_cast<float>(static_cast<int8_t>((word >> (8 * c)) & 0xFFu));
  }
}

template <typename XT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scale, float* __restrict__ dst,
           int M, int K, int N, int k_chunk) {
  constexpr int C = PACKED ? 8 : 4;  // columns per thread (one 32-bit word)
  constexpr int BN = 32 * C;         // columns per block
  const int row_bytes = PACKED ? N / 2 : N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN + lane * C;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int byte0 = PACKED ? n0 / 2 : n0;
  const bool vec = (row_bytes % 4 == 0) && (n0 + C <= N);

  __shared__ float xs[kBM][kKSub];
  __shared__ float red[kWarps][BN];

  float sc[C];
  float acc[kBM][C];
#pragma unroll
  for (int c = 0; c < C; ++c) sc[c] = (n0 + c < N) ? scale[n0 + c] : 0.f;
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += kKSub) {
    const int kn = min(kKSub, k_end - ks);
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kKSub; i += kThreads) {
      const int m = i / kKSub, kk = i % kKSub;
      xs[m][kk] = (m0 + m < M && kk < kn)
                      ? to_f32(x[(size_t)(m0 + m) * K + ks + kk]) : 0.f;
    }
    __syncthreads();
    if (n0 < N) {
#pragma unroll 4
      for (int kk = warp; kk < kn; kk += kWarps) {
        const uint8_t* row = codes + (size_t)(ks + kk) * row_bytes + byte0;
        float w[C];
        if (vec) {
          decode_word<PACKED>(__ldg(reinterpret_cast<const uint32_t*>(row)), w);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (n0 + c >= N) { w[c] = 0.f; continue; }
            if (PACKED) {
              const uint32_t b = row[c >> 1];
              w[c] = static_cast<float>(static_cast<int>((b >> (4 * (c & 1))) & 0xFu) - 8);
            } else {
              w[c] = static_cast<float>(static_cast<int8_t>(row[c]));
            }
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) w[c] *= sc[c];  // dequantize in f32
#pragma unroll
        for (int m = 0; m < kBM; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
        }
      }
    }
  }

  // cross-warp reduction, one x row at a time, in a fixed order
  float* out = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) red[warp][lane * C + c] = acc[m][c];
    __syncthreads();
    for (int j = threadIdx.x; j < BN; j += kThreads) {
      const int n = blockIdx.x * BN + j;
      if (m0 + m < M && n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][j];
        out[(size_t)(m0 + m) * N + n] = s;
      }
    }
  }
}

__global__ void splitk_reduce(const float* __restrict__ part, float* __restrict__ out,
                              int splits, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * mn + i];
  out[i] = s;
}

}  // namespace
