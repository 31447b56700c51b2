// qmm — fused dequantize-matmul over int8 or nibble-packed int4 code planes.
//
// Replaces: src/repro/kernels/qmm.py · qmm (_qmm_kernel), the Pallas TPU
// kernel behind every QTensor-weighted layers.dense.
//
// Computes y[M, N] = x[M, K] · (codes[K, N] ⊙ scale[N]) in f32: each code is
// dequantized in f32 in registers (code · scale, the Pallas numerics of
// qmm.py:_dequant_block) and accumulated in f32. x is bf16 or f32; codes are
// int8 (K, N) or packed int4 (K, N/2) uint8 (offset-binary, code + 8, low
// nibble = even column).
//
// What bounds it on an H100: on the decode path M is the number of slots
// (≤ 8), so this is a weight-streaming GEMV — about 2·M·K·N operations
// against K·N code bytes, far below the card's ~295 operations per byte:
// the bound is the code bytes over HBM bandwidth (int8 ≈ 110 MB per
// gemma-2b layer, int4 half of that).
//
// What the design does about it: every code byte is read exactly once per
// block row of x. A warp reads one code row as 128 contiguous bytes (one
// 32-bit word per lane: 4 int8 or 8 int4 columns), eight warps stride the
// K rows, and the grid splits K (gridDim.z) so that even N = 256 (the k/v
// projections) puts a few hundred blocks on the 132 SMs. Split-K partials
// land in a scratch plane and a second small kernel sums them in a fixed
// order, so results are deterministic. Ragged M, K and N are masked inside
// the kernel; nothing is padded. Prefill (M = prompt bucket) reuses the
// same kernel with one block row per 8 rows of x. wgmma/TMA tiles for the
// large-M prefill are later work.
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

template <typename XT, bool PACKED>
cudaError_t launch(const void* x, const uint8_t* codes, const float* scale,
                   float* out, float* part, int M, int K, int N, int splits,
                   cudaStream_t stream) {
  constexpr int BN = 32 * (PACKED ? 8 : 4);
  const int k_chunk = (K + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, splits);
  float* dst = splits > 1 ? part : out;
  qmm_kernel<XT, PACKED><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), codes, scale, dst, M, K, N, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(part, out, splits, mn);
  return cudaGetLastError();
}

}  // namespace

// y (M, N) f32 = x (M, K) · dequant(codes, scale). x_bf16 selects the x
// type (else f32); packed selects (K, N/2) uint8 int4 codes (else (K, N)
// int8). part is a (splits, M, N) f32 scratch plane when splits > 1.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int qmm_launch(const void* x, int x_bf16, const void* codes,
                          int packed, const float* scale, float* out,
                          float* part, int M, int K, int N, int splits,
                          void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return packed ? launch<__nv_bfloat16, true>(x, c, scale, out, part, M, K, N, splits, s)
                  : launch<__nv_bfloat16, false>(x, c, scale, out, part, M, K, N, splits, s);
  return packed ? launch<float, true>(x, c, scale, out, part, M, K, N, splits, s)
                : launch<float, false>(x, c, scale, out, part, M, K, N, splits, s);
}

extern "C" const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
