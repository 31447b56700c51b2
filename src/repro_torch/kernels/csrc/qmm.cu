// qmm — fused dequantize-matmul over int8 or nibble-packed int4 code planes.
//
// Replaces: src/repro/kernels/qmm.py · qmm (_qmm_kernel), the Pallas TPU
// kernel behind every QTensor-weighted layers.dense.
//
// Computes y[M, N] = (x[M, K] · codes[K, N]) ⊙ scale[N] with f32
// accumulation. x is bf16 or f32; codes are int8 (K, N) or packed int4
// (K, N/2) uint8 (offset-binary, code + 8, low nibble = even column). The
// scale is per column, so it may follow the contraction: the products are
// those of the codes themselves.
//
// What bounds it on an H100, and the design's answer (the product blocks
// are in qmm_core.cuh, shared with qmm_qout.cu; kernels/qmm.py · plan
// chooses the core and the K splits, and passes them here):
//
// * Decode (M ≤ plan's threshold, 8), and f32 x at any M — the SIMT core.
//   About 2·M·K·N operations against K·N code bytes is far below the
//   card's ~295 operations per byte, so the bound is the code bytes over
//   HBM bandwidth (int8 ≈ 110 MB per gemma-2b layer). Each lane reads one
//   vector of a code row (16 bytes: 16 int8 codes; 8 bytes: 16 int4
//   codes, with twice the rows in flight), a warp keeps 4 (int4: 8) rows in
//   flight, eight warps stride the K rows, and K is split (gridDim.z) until
//   some 264 blocks fill the 132 SMs. Codes turn into floats with a byte
//   permute and an FADD (no I2F), x·code accumulates in f32 and the scale
//   multiplies once at the end.
//
// * bf16 x above the threshold (prefill, training) — the tensor-core core.
//   2·M·K·N operations against x and the codes once each is far above the
//   ridge: the bound is the bf16 tensor-core rate, which computes this
//   function exactly, since bf16 holds every int8 and int4 code and the
//   per-column scale follows the contraction. One 128 × 256 output tile per
//   block (one block per SM: 193 KB of dynamic shared memory, opted in with
//   cudaFuncSetAttribute), K steps of 64: x tiles (bf16, 128B-swizzled) and
//   raw code tiles land in a 4-deep cp.async ring (16-byte copies where the
//   base and the row stride allow, else 8, 4 or plain loads: an unaligned
//   view is read in place); each code tile is converted to bf16 once per
//   block, into the MN-major swizzled layout that wgmma reads as a
//   transposed B; two warpgroups multiply their 64 rows by it with
//   asynchronous wgmma m64n128k16, one 128-column half at a time, the
//   first while their threads load and convert the next tiles. The wide
//   tile halves the re-reads of x (bf16, the larger operand per tile)
//   against a 128 × 128 tile. The tensor cores' f32 accumulation rounds
//   toward zero, so each K step's product starts from zero and is added to
//   f32 accumulators with FADD (round to nearest): the kernel then agrees
//   with the exact product better than the f32-dequant plain version does.
//   Split-K fills the card where the tiles alone cannot (M 2048 × N 256,
//   M 112 × N 2048).
//
// Both cores mask ragged M, N and K inside the kernel; nothing is padded.
// Split-K partials land in a scratch plane and splitk_reduce sums them in a
// fixed order, so results are deterministic. A TMA producer warp (and x
// multicast across a cluster) is the next step for the tensor-core core.
#include "qmm_core.cuh"

// y (M, N) f32 = x (M, K) · dequant(codes, scale) on plan's core (0 SIMT,
// 1 tensor cores), K in `splits` slices of k_chunk rows. x_bf16 selects
// the x type (else f32); packed selects (K, N/2) uint8 int4 codes (else
// (K, N) int8). part is a (splits, M, N) f32 scratch plane when
// splits > 1. Returns the cudaError_t of the launches (0 = success).
extern "C" int qmm_launch(const void* x, int x_bf16, const void* codes, int packed,
                          const float* scale, float* out, float* part, int M, int K, int N,
                          int core, int splits, int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_product(core, x_bf16, x, static_cast<const uint8_t*>(codes),
                                   packed, scale, splits > 1 ? part : out, M, K, N, splits,
                                   k_chunk, s);
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, out, splits, mn);
  return cudaGetLastError();
}

extern "C" const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
