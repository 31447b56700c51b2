// qmm_t — the transposed dequantize-matmul: dx = g · (codes ⊙ scale)ᵀ.
//
// Replaces: src/repro/kernels/qmm.py · qmm_t (_qmm_t_kernel), the Pallas
// TPU kernel behind the code-domain backward of every QTensor / ShipWeight
// matmul (quant_dense's VJP: dx streams codes instead of re-decoding a
// bf16 weight).
//
// Computes dx[M, K] = Σ_n g[M, n] · codes[K, n] · scale[n] in f32: each code
// is dequantized in f32 (code · scale, the Pallas numerics of
// qmm.py:_dequant_block) and accumulated in f32. g is f32 or bf16; codes
// are int8 (K, N) or packed int4 (K, N/2) uint8 (offset-binary, code + 8,
// low nibble = even column). M, K and N may be ragged: every load and store
// is masked, nothing is padded.
//
// What bounds it on an H100: on the training path M = B·S = 2048 tokens, so
// a weight (K, N) costs 2·M·K·N operations against ~K·N code bytes — about
// 4000 operations per byte, far above the card's balance point: the bound
// is the operations. The f32 dequantize keeps them off the tensor cores
// (bf16 or TF32 operands would break the reference's f32 contract), so the
// peak is the 67 TFLOP/s of f32 FMAs on the CUDA cores.
//
// What the design does about it: a classic shared-memory SGEMM. A block of
// 256 threads owns a 128 × 128 tile of dx and walks N in chunks of 32:
// each chunk stages g (128 rows × 32) and the dequantized codes (128 K-rows
// × 32) in shared memory, n-major, and every thread accumulates an 8 × 8
// micro-tile in registers from two float4 reads of each operand per n.
// The codes are read once per 128 rows of g. wgmma on bf16 tiles, TMA and
// a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // rows of g (and dx) per block
constexpr int kBK = 128;   // rows of codes (columns of dx) per block
constexpr int kBN = 32;    // contraction chunk along N

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool PACKED>
__device__ __forceinline__ float code_at(const uint8_t* __restrict__ codes,
                                         long long row_bytes, int k, int n) {
  if (PACKED) {
    const uint32_t b = codes[(long long)k * row_bytes + (n >> 1)];
    return static_cast<float>(static_cast<int>((b >> (4 * (n & 1))) & 0xFu) - 8);
  }
  return static_cast<float>(static_cast<int8_t>(codes[(long long)k * row_bytes + n]));
}

template <typename GT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
qmm_t_kernel(const GT* __restrict__ g, const uint8_t* __restrict__ codes,
             const float* __restrict__ scale, float* __restrict__ dx,
             int M, int K, int N) {
  __shared__ __align__(16) float gs[kBN][kBM];
  __shared__ __align__(16) float ws[kBN][kBK];

  const int t = threadIdx.x;
  const int tx = t & 15;          // micro-tile column group (K)
  const int ty = t >> 4;          // micro-tile row group (M)
  const int k0 = blockIdx.x * kBK;
  const int m0 = blockIdx.y * kBM;
  const long long row_bytes = PACKED ? N / 2 : N;

  // staging: thread t loads 16 consecutive n of row (t % 128) of each tile
  const int lrow = t & 127;
  const int lcol = (t >> 7) * 16;
  const int gm = m0 + lrow;
  const int wk = k0 + lrow;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      const int n = n0 + lcol + c;
      const bool nin = n < N;
      gs[lcol + c][lrow] = (nin && gm < M) ? to_f32(g[(long long)gm * N + n]) : 0.f;
      ws[lcol + c][lrow] = (nin && wk < K)
          ? code_at<PACKED>(codes, row_bytes, wk, n) * __ldg(scale + n) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < kBN; ++n) {
      const float4 a0 = *reinterpret_cast<const float4*>(&gs[n][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gs[n][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[n][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[n][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (k < K) dx[(long long)m * K + k] = acc[i][j];
    }
  }
}

template <typename GT, bool PACKED>
cudaError_t launch(const void* g, const uint8_t* codes, const float* scale,
                   float* dx, int M, int K, int N, cudaStream_t stream) {
  dim3 grid((K + kBK - 1) / kBK, (M + kBM - 1) / kBM);
  qmm_t_kernel<GT, PACKED><<<grid, kThreads, 0, stream>>>(
      static_cast<const GT*>(g), codes, scale, dx, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// dx (M, K) f32 = g (M, N) · dequant(codes, scale)ᵀ. g_bf16 selects the g
// type (else f32); packed selects (K, N/2) uint8 int4 codes (else (K, N)
// int8); scale has N entries. All arrays contiguous. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int qmm_t_launch(const void* g, int g_bf16, const void* codes,
                            int packed, const float* scale, float* dx, int M,
                            int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return packed ? launch<__nv_bfloat16, true>(g, c, scale, dx, M, K, N, s)
                  : launch<__nv_bfloat16, false>(g, c, scale, dx, M, K, N, s);
  return packed ? launch<float, true>(g, c, scale, dx, M, K, N, s)
                : launch<float, false>(g, c, scale, dx, M, K, N, s);
}

extern "C" const char* qmm_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
