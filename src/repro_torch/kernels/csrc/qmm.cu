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
#include "qmm_core.cuh"

namespace {

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
