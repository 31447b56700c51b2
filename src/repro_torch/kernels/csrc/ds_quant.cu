// ds_quant — fused double-sampling quantization: both int8 code planes of
// the §2.2 pair from one read of x.
//
// Replaces: src/repro/kernels/stoch_quant.py · ds_quant (_ds_quant_kernel),
// the Pallas TPU kernel behind ops.ds_quantize on the linear-model path.
//
// Computes, per element, with t = clip(|x| / max(scale, 1e-30), 0, 1) · s:
//   base = clip(floor(t), 0, s − 1), frac = t − base,
//   codeᵢ = sign(x) · (base + [uᵢ < frac]),
//   u1 = (w >> 16) · 2⁻¹⁶, u2 = (w & 0xFFFF) · 2⁻¹⁶,
// and both codes 0 where |x| / scale is NaN (a NaN x or scale), as the
// reference's cast of NaN to int8 gives,
// against row scales (R) or column scales (C). x is f32 or bf16, the codes
// int8 in [−s, s]. w is one uint32 word per element, from one of two
// entries: the parity entry reads it from a rand plane (ds_quant_launch:
// the Pallas kernel's operand and contract); the keyed entry
// (ds_quant_keyed_launch) hashes it in registers as bits_at(k1, k2, i) of
// csrc/threefry.cuh at the element's flat index i — the word
// jax.random.bits(key, (R, C)) holds there — so no plane reaches HBM and a
// call is one launch, not the plane's plus this one.
//
// Bit-exact with the plain version (kernels/ref.ds_quant_ref) given the
// same words: the division is IEEE (__fdiv_rn), and t and frac are rounded
// separately (__fmul_rn, __fsub_rn) — nvcc would otherwise contract
// clip(mag)·s − base into one FMA and flip codes where u sits next to frac.
//
// What bounds it on an H100: the parity entry moves 10 bytes per element
// (4 of x, 4 of rand, 2 of codes) against a handful of operations: bytes.
// The keyed entry moves 6 (x, two code planes) and hashes 73 32-bit integer
// operations per element (csrc/threefry.cuh), 41 of them on the integer ALU
// pipe alone: at 64 of those per clock per SM (compute capability 9.0)
// that outweighs the bytes, so a large call is integer-bound. The design
// reads x with consecutive threads on consecutive elements (coalesced) and
// writes both planes in the same pass;
// a grid-stride loop covers any size, ragged edges included, its (row,
// column) advanced without a division in the loop. At the linear path's
// batch of 16 rows the call is launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// KEYED: the words come from bits_at(k1, k2, i), else from rand[i]
template <typename XT, bool KEYED>
__global__ void ds_quant_kernel(const XT* __restrict__ x,
                                const uint32_t* __restrict__ rand, uint32_t k1,
                                uint32_t k2, const float* __restrict__ scale,
                                int col_scale, int8_t* __restrict__ c1,
                                int8_t* __restrict__ c2, long long R, long long C, int s) {
  const long long n = R * C;
  const long long step = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float fs = static_cast<float>(s);
  const float top = static_cast<float>(s - 1);
  // the element's (row, column), advanced by (dr, dc) with the index
  const long long dr = step / C, dc = step - dr * C;
  long long r = i / C, c = i - r * C;
  for (; i < n; i += step) {
    const float xv = to_f32(x[i]);
    const float sr = scale[col_scale ? c : r];
    uint32_t u;
    if constexpr (KEYED) {
      u = bits_at(k1, k2, static_cast<unsigned long long>(i));
    } else {
      u = rand[i];
    }
    c += dc;
    r += dr;
    if (c >= C) {
      c -= C;
      ++r;
    }
    const float mag = __fdiv_rn(fabsf(xv), isnan(sr) ? sr : fmaxf(sr, 1e-30f));
    if (isnan(mag)) {  // a NaN x or scale: XLA's float→int cast gives 0
      c1[i] = c2[i] = 0;
      continue;
    }
    const float t = __fmul_rn(fminf(fmaxf(mag, 0.f), 1.f), fs);
    const float base = fminf(fmaxf(floorf(t), 0.f), top);
    const float frac = __fsub_rn(t, base);
    const float u1 = static_cast<float>(u >> 16) * (1.f / 65536.f);
    const float u2 = static_cast<float>(u & 0xFFFFu) * (1.f / 65536.f);
    const float sg = xv > 0.f ? 1.f : (xv < 0.f ? -1.f : 0.f);
    c1[i] = static_cast<int8_t>(static_cast<int>((base + (u1 < frac ? 1.f : 0.f)) * sg));
    c2[i] = static_cast<int8_t>(static_cast<int>((base + (u2 < frac ? 1.f : 0.f)) * sg));
  }
}

template <typename XT, bool KEYED>
cudaError_t launch(const void* x, const uint32_t* rand, uint32_t k1, uint32_t k2,
                   const float* scale, int col_scale, int8_t* c1, int8_t* c2, long long R,
                   long long C, int s, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long n = R * C;
  if (n <= 0) return cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  ds_quant_kernel<XT, KEYED><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), rand, k1, k2, scale, col_scale, c1, c2, R, C, s);
  return cudaGetLastError();
}

template <bool KEYED>
int dispatch(const void* x, int x_bf16, const void* rand, uint32_t k1, uint32_t k2,
             const float* scale, int col_scale, void* c1, void* c2, long long R,
             long long C, int s, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(rand);
  int8_t* o1 = static_cast<int8_t*>(c1);
  int8_t* o2 = static_cast<int8_t*>(c2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16
      ? launch<__nv_bfloat16, KEYED>(x, r, k1, k2, scale, col_scale, o1, o2, R, C, s, st)
      : launch<float, KEYED>(x, r, k1, k2, scale, col_scale, o1, o2, R, C, s, st);
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
  return dispatch<false>(x, x_bf16, rand, 0u, 0u, scale, col_scale, c1, c2, R, C, s,
                         stream);
}

// The keyed entry: as ds_quant_launch, with the word of element i hashed
// from the key (k1, k2) at counter i (jax.random.bits(key, (R, C))[i]).
extern "C" int ds_quant_keyed_launch(const void* x, int x_bf16, unsigned int k1,
                                     unsigned int k2, const float* scale, int col_scale,
                                     void* c1, void* c2, long long R, long long C, int s,
                                     void* stream) {
  return dispatch<true>(x, x_bf16, nullptr, k1, k2, scale, col_scale, c1, c2, R, C, s,
                        stream);
}

extern "C" const char* ds_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
