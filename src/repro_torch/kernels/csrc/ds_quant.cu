// ds_quant — fused double-sampling quantization: both int8 code planes of
// the §2.2 pair from one read of x.
//
// Replaces: src/repro/kernels/stoch_quant.py · ds_quant (_ds_quant_kernel),
// the Pallas TPU kernel behind ops.ds_quantize on the linear-model path.
//
// Computes, per element, with t = clip(|x| / max(scale, 1e-30), 0, 1) · s:
//   base = clip(floor(t), 0, s − 1), frac = t − base,
//   codeᵢ = sign(x) · (base + [uᵢ < frac]),
//   u1 = (rand >> 16) · 2⁻¹⁶, u2 = (rand & 0xFFFF) · 2⁻¹⁶,
// against row scales (R) or column scales (C). x is f32 or bf16, rand one
// uint32 word per element, the codes int8 in [−s, s].
//
// Bit-exact with the plain version (kernels/ref.ds_quant_ref) given the
// same rand: the division is IEEE (__fdiv_rn), and t and frac are rounded
// separately (__fmul_rn, __fsub_rn) — nvcc would otherwise contract
// clip(mag)·s − base into one FMA and flip codes where u sits next to frac.
//
// What bounds it on an H100: an elementwise pass, 10 bytes per element
// (4 of x, 4 of rand, 2 of codes) against a handful of operations: the
// bytes over HBM bandwidth. The design reads x and rand with consecutive
// threads on consecutive elements (coalesced) and writes both planes in the
// same pass; a grid-stride loop covers any size, ragged edges included. At
// the linear path's batch of 16 rows the call is launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void ds_quant_kernel(const XT* __restrict__ x,
                                const uint32_t* __restrict__ rand,
                                const float* __restrict__ scale, int col_scale,
                                int8_t* __restrict__ c1, int8_t* __restrict__ c2,
                                long long R, long long C, int s) {
  const long long n = R * C;
  const float fs = static_cast<float>(s);
  const float top = static_cast<float>(s - 1);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float xv = to_f32(x[i]);
    const float sc = fmaxf(scale[col_scale ? i % C : i / C], 1e-30f);
    const float mag = __fdiv_rn(fabsf(xv), sc);
    const float t = __fmul_rn(fminf(fmaxf(mag, 0.f), 1.f), fs);
    const float base = fminf(fmaxf(floorf(t), 0.f), top);
    const float frac = __fsub_rn(t, base);
    const uint32_t u = rand[i];
    const float u1 = static_cast<float>(u >> 16) * (1.f / 65536.f);
    const float u2 = static_cast<float>(u & 0xFFFFu) * (1.f / 65536.f);
    const float sg = xv > 0.f ? 1.f : (xv < 0.f ? -1.f : 0.f);
    c1[i] = static_cast<int8_t>(static_cast<int>((base + (u1 < frac ? 1.f : 0.f)) * sg));
    c2[i] = static_cast<int8_t>(static_cast<int>((base + (u2 < frac ? 1.f : 0.f)) * sg));
  }
}

template <typename XT>
cudaError_t launch(const void* x, const uint32_t* rand, const float* scale,
                   int col_scale, int8_t* c1, int8_t* c2, long long R,
                   long long C, int s, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long n = R * C;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  if (blocks < 1) blocks = 1;
  ds_quant_kernel<XT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), rand, scale, col_scale, c1, c2, R, C, s);
  return cudaGetLastError();
}

}  // namespace

// codes1, codes2 (R, C) int8 from x (R, C) (x_bf16 selects bf16, else f32)
// and rand (R, C) uint32, against scale[R] (col_scale = 0) or scale[C]
// (col_scale = 1). All arrays contiguous. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int ds_quant_launch(const void* x, int x_bf16, const void* rand,
                               const float* scale, int col_scale, void* c1,
                               void* c2, long long R, long long C, int s,
                               void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(rand);
  int8_t* o1 = static_cast<int8_t*>(c1);
  int8_t* o2 = static_cast<int8_t*>(c2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, r, scale, col_scale, o1, o2, R, C, s, st)
                : launch<float>(x, r, scale, col_scale, o1, o2, R, C, s, st);
}

extern "C" const char* ds_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
