// qmm_qout — the dequantize-matmul y = x · (codes ⊙ scale) with a fused
// §2.2 double-sampling epilogue: both int8 code planes of y's row-scaled
// pair and the row scales, without a dense y in device memory beside the
// product's own split-K partials.
//
// Replaces: src/repro/kernels/qmm.py · qmm_qout (_qmm_qout_kernel), the
// Pallas TPU kernel behind ops.quant_dense_out_q (quant_dense_q,
// act_quant.ds_project).
//
// Computes, for x (M, K) bf16/f32, codes (K, N) int8 or (K, N/2) packed
// int4 (offset-binary, as csrc/qmm.cu), scale (N) f32, rand (M, N) uint32:
//   y      = cast_out_dtype(x · (codes ⊙ scale))         (f32 accumulation)
//   absmax = max_n |y[m, n]|                              (NaN propagates)
//   s[m]   = absmax == 0 ? 1 : absmax / qmax
//   t = y / s[m], base = floor(t), frac = t − base,
//   codeᵢ = clip(base + [uᵢ < frac], −qmax, qmax),
//   u1 = (rand >> 16) · 2⁻¹⁶, u2 = (rand & 0xFFFF) · 2⁻¹⁶,
// a NaN t giving code 0, as the reference's cast of NaN to int8 does.
//
// Design: two launches. The first is qmm's own product (qmm_core.cuh, the
// same source as csrc/qmm.cu) on the core and K splits that
// kernels/qmm.py · plan gives qmm for the same operands: the SIMT core at
// decode M and for f32 x, the bf16 tensor-core core above plan's threshold.
// It always writes its f32 partials to a (splits, M, N) scratch plane;
// with one split that plane is y itself. The second, one block per row of
// y, sums the partials in qmm's fixed order (qmm's splitk_reduce), rounds
// to out_dtype, reduces the row absmax in shared memory (the absmax spans
// the whole N, so every N tile must be summed before any element is
// encoded), then sums the partials again and encodes both planes. So the
// output equals the port's unfused qmm → cast → encode pipeline bit for
// bit, at every M, on either core. Each operation of the encode rounds on
// its own (__fdiv_rn, __fsub_rn, __fmul_rn, __fadd_rn), as in
// csrc/ds_quant.cu: nvcc's FMA contraction flipped codes there.
//
// What bounds it on an H100: at the training batch (M 2048) the product's
// 2·M·K·N operations at the bf16 tensor-core rate (the product's design
// notes are in qmm.cu); at decode (M 4) the code bytes. The epilogue moves
// the partials twice, the rand plane (4 bytes per element, the largest
// input at M 2048) and the two planes once; at decode M its one block per
// row leaves most SMs idle (ROADMAP P6).
#include "qmm_core.cuh"

namespace {

constexpr int kEpiThreads = 256;

template <bool OUT_BF16>
__device__ __forceinline__ float row_value(const float* __restrict__ part, int splits,
                                           long long mn, long long i) {
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * mn + i];
  if (OUT_BF16) s = __bfloat162float(__float2bfloat16_rn(s));
  return s;
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(kEpiThreads)
qout_epilogue(const float* __restrict__ part, const uint32_t* __restrict__ rand,
              int8_t* __restrict__ c1, int8_t* __restrict__ c2,
              float* __restrict__ oscale, int M, int N, int splits, int qmax) {
  __shared__ float red[kEpiThreads / 32];
  __shared__ float row_scale;
  const int m = blockIdx.x;
  const long long mn = (long long)M * N;
  const long long row0 = (long long)m * N;

  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += kEpiThreads)
    amax = nan_max(amax, fabsf(row_value<OUT_BF16>(part, splits, mn, row0 + n)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red[0];
    for (int w = 1; w < kEpiThreads / 32; ++w) a = nan_max(a, red[w]);
    const float s = (a == 0.f) ? 1.f : __fdiv_rn(a, static_cast<float>(qmax));
    row_scale = s;
    oscale[m] = s;
  }
  __syncthreads();
  const float s = row_scale;
  const float q = static_cast<float>(qmax);
  const float inv16 = 1.f / 65536.f;
  for (int n = threadIdx.x; n < N; n += kEpiThreads) {
    const long long i = row0 + n;
    const float t = __fdiv_rn(row_value<OUT_BF16>(part, splits, mn, i), s);
    int8_t a = 0, b = 0;
    if (!isnan(t)) {
      const float base = floorf(t);
      const float frac = __fsub_rn(t, base);
      const uint32_t r = rand[i];
      const float u1 = __fmul_rn(static_cast<float>(r >> 16), inv16);
      const float u2 = __fmul_rn(static_cast<float>(r & 0xFFFFu), inv16);
      const float v1 = __fadd_rn(base, u1 < frac ? 1.f : 0.f);
      const float v2 = __fadd_rn(base, u2 < frac ? 1.f : 0.f);
      a = static_cast<int8_t>(fminf(fmaxf(v1, -q), q));
      b = static_cast<int8_t>(fminf(fmaxf(v2, -q), q));
    }
    c1[i] = a;
    c2[i] = b;
  }
}

cudaError_t launch(int core, int x_bf16, const void* x, const uint8_t* codes, int packed,
                   const float* scale, const uint32_t* rand, float* part, int8_t* c1,
                   int8_t* c2, float* oscale, int M, int K, int N, int splits, int k_chunk,
                   int qmax, int out_bf16, cudaStream_t stream) {
  cudaError_t err = launch_product(core, x_bf16, x, codes, packed, scale, part, M, K, N,
                                   splits, k_chunk, stream);
  if (err != cudaSuccess) return err;
  if (out_bf16)
    qout_epilogue<true><<<M, kEpiThreads, 0, stream>>>(part, rand, c1, c2, oscale, M, N,
                                                       splits, qmax);
  else
    qout_epilogue<false><<<M, kEpiThreads, 0, stream>>>(part, rand, c1, c2, oscale, M, N,
                                                        splits, qmax);
  return cudaGetLastError();
}

}  // namespace

// (codes1, codes2) int8 (M, N) and row scales (M) f32 of the DS pair of
// cast_out(x (M, K) · dequant(codes, scale)), the product on plan's core
// (0 SIMT, 1 tensor cores) with K in `splits` slices of k_chunk rows. x_bf16
// selects the x type (else f32), packed the (K, N/2) int4 codes (else
// (K, N) int8), out_bf16 rounds y to bf16 before the encode (else f32).
// part is a (splits, M, N) f32 scratch plane. Returns the cudaError_t of
// the launches (0 = success).
extern "C" int qmm_qout_launch(const void* x, int x_bf16, const void* codes, int packed,
                               const float* scale, const void* rand, float* part, void* c1,
                               void* c2, float* oscale, int M, int K, int N, int core,
                               int splits, int k_chunk, int qmax, int out_bf16,
                               void* stream) {
  return launch(core, x_bf16, x, static_cast<const uint8_t*>(codes), packed, scale,
                static_cast<const uint32_t*>(rand), part, static_cast<int8_t*>(c1),
                static_cast<int8_t*>(c2), oscale, M, K, N, splits, k_chunk, qmax, out_bf16,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* qmm_qout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
