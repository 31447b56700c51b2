// row_absmax and stoch_quant — the two single-plane quantizer kernels behind
// ops.quantize_rows (row_absmax, then stoch_quant) and ops.ds_quantize with
// scale=None (row_absmax, then ds_quant).
//
// Replaces: src/repro/kernels/stoch_quant.py · row_absmax (_absmax_kernel)
// and · stoch_quant (_sq_kernel), the Pallas TPU kernels of the paper's
// row-scaled stochastic quantizer.
//
// row_absmax: x (R, C) f32/bf16 → (R, 1) f32 max|x| per row. One CTA per row
// (a grid-stride over rows beyond the grid): the threads stride over the
// row's columns with 16-byte vector loads between a scalar head that reaches
// 16-byte alignment and a scalar tail, reduce with warp shuffles, then across
// warps through shared memory. The max propagates NaN, as jnp.max and
// torch.amax do (common.cuh's nan_max; fmaxf would drop it); fabsf maps −0
// to +0, as the reference's abs does. A max is exact in any order, so the
// result is bit-exact with the plain version.
//
// stoch_quant: x (R, C) f32/bf16, rand (R, C) uint32, scale (R) f32 → int8
// codes in [−s, s], bit-exact with kernels/ref.stoch_quant_ref given rand:
//   u = (rand >> 8) · 2⁻²⁴, mag = |x| / max(scale, 1e-30),
//   t = clip(mag, 0, 1) · s, lo = clip(floor(t), 0, s − 1),
//   code = (lo + [u < t − lo]) · sign(x),
// and code 0 where mag is NaN (a NaN x, or a NaN scale from row_absmax),
// which is what the reference's cast of NaN to int8 gives.
// Every operation is rounded on its own (__fdiv_rn, __fmul_rn, __fsub_rn):
// nvcc would otherwise contract clip(mag)·s − lo into one FMA and flip codes
// where u sits next to the fraction. One thread takes 4 consecutive
// elements: with 16-byte-aligned x and rand it loads them as one vector
// each and stores 4 codes as one 32-bit word; otherwise (a view at an odd
// offset) element by element.
//
// What bounds them on an H100: both are single passes with a handful of
// operations per element, so the bytes over HBM bandwidth. row_absmax reads
// x once (4 bytes an element for f32) and writes 4 bytes a row; stoch_quant
// reads x and rand and writes the codes, 9 bytes an element for f32 x. At
// the linear path's (16, 5000) the calls are launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kAbsmaxThreads = 256;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// |x| of the VEC elements held in one 16-byte word, folded into m
__device__ __forceinline__ float vec_absmax(float m, const uint4& w, float) {
  m = nan_max(m, fabsf(__uint_as_float(w.x)));
  m = nan_max(m, fabsf(__uint_as_float(w.y)));
  m = nan_max(m, fabsf(__uint_as_float(w.z)));
  return nan_max(m, fabsf(__uint_as_float(w.w)));
}

__device__ __forceinline__ float vec_absmax(float m, const uint4& w, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    m = nan_max(m, fabsf(f.x));
    m = nan_max(m, fabsf(f.y));
  }
  return m;
}

template <typename XT>
__global__ void row_absmax_kernel(const XT* __restrict__ x, float* __restrict__ out,
                                  long long R, long long C) {
  constexpr int kVec = 16 / sizeof(XT);
  __shared__ float warp_max[kAbsmaxThreads / 32];
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const XT* row = x + r * C;
    // scalar head up to 16-byte alignment, vector body, scalar tail
    const long long mis = (reinterpret_cast<uintptr_t>(row) & 15) / sizeof(XT);
    long long head = mis ? kVec - mis : 0;
    if (head > C) head = C;
    const long long nvec = (C - head) / kVec;
    const long long tail0 = head + nvec * kVec;
    float m = 0.f;
    for (long long i = threadIdx.x; i < head; i += blockDim.x)
      m = nan_max(m, fabsf(to_f32(row[i])));
    const uint4* body = reinterpret_cast<const uint4*>(row + head);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x)
      m = vec_absmax(m, __ldg(body + i), XT());
    for (long long i = tail0 + threadIdx.x; i < C; i += blockDim.x)
      m = nan_max(m, fabsf(to_f32(row[i])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < kAbsmaxThreads / 32 ? warp_max[lane] : 0.f;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) out[r] = m;
    }
    __syncthreads();   // warp_max is reused by the next row
  }
}

__device__ __forceinline__ int8_t quant_one(float xv, uint32_t rnd, float sc,
                                            float fs, float top) {
  const float u = static_cast<float>(rnd >> 8) * (1.f / 16777216.f);
  const float mag = __fdiv_rn(fabsf(xv), isnan(sc) ? sc : fmaxf(sc, 1e-30f));
  if (isnan(mag)) return 0;  // a NaN x or scale: XLA's float→int cast gives 0
  const float t = __fmul_rn(fminf(fmaxf(mag, 0.f), 1.f), fs);
  const float lo = fminf(fmaxf(floorf(t), 0.f), top);
  const float code = lo + (u < __fsub_rn(t, lo) ? 1.f : 0.f);
  const float sg = xv > 0.f ? 1.f : (xv < 0.f ? -1.f : 0.f);
  return static_cast<int8_t>(static_cast<int>(code * sg));
}

__device__ __forceinline__ void load4(const float* x, long long i, float* v) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(x + i));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* x, long long i, float* v) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(x + i));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename XT, bool kVecIO>
__global__ void stoch_quant_kernel(const XT* __restrict__ x,
                                   const uint32_t* __restrict__ rand,
                                   const float* __restrict__ scale,
                                   int8_t* __restrict__ codes, long long R,
                                   long long C, int s) {
  const long long n = R * C;
  const float fs = static_cast<float>(s);
  const float top = static_cast<float>(s - 1);
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q * 4 < n;
       q += (long long)gridDim.x * blockDim.x) {
    const long long i = q * 4;
    if (kVecIO && i + 4 <= n) {
      float v[4];
      load4(x, i, v);
      const uint4 rw = __ldg(reinterpret_cast<const uint4*>(rand + i));
      const uint32_t rr[4] = {rw.x, rw.y, rw.z, rw.w};
      char4 out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = quant_one(v[e], rr[e], scale[(i + e) / C], fs, top);
      *reinterpret_cast<char4*>(codes + i) = out;
    } else {
      for (long long j = i; j < i + 4 && j < n; ++j)
        codes[j] = quant_one(to_f32(x[j]), rand[j], scale[j / C], fs, top);
    }
  }
}

template <typename XT>
cudaError_t launch_absmax(const void* x, float* out, long long R, long long C,
                          cudaStream_t stream) {
  long long blocks = R < 65535LL * 16 ? R : 65535LL * 16;
  if (blocks < 1) blocks = 1;
  row_absmax_kernel<XT><<<(unsigned)blocks, kAbsmaxThreads, 0, stream>>>(
      static_cast<const XT*>(x), out, R, C);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_quant(const void* x, const uint32_t* rand, const float* scale,
                         int8_t* codes, long long R, long long C, int s, int vec_io,
                         cudaStream_t stream) {
  const long long quads = (R * C + 3) / 4;
  long long blocks = (quads + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  if (blocks < 1) blocks = 1;
  const XT* xp = static_cast<const XT*>(x);
  if (vec_io)
    stoch_quant_kernel<XT, true><<<(unsigned)blocks, kQuantThreads, 0, stream>>>(
        xp, rand, scale, codes, R, C, s);
  else
    stoch_quant_kernel<XT, false><<<(unsigned)blocks, kQuantThreads, 0, stream>>>(
        xp, rand, scale, codes, R, C, s);
  return cudaGetLastError();
}

}  // namespace

// out[R] f32 = max |x[r, :]| for x (R, C) contiguous (x_bf16 selects bf16,
// else f32), C >= 1. Returns the cudaError_t of the launch (0 = success).
extern "C" int row_absmax_launch(const void* x, int x_bf16, void* out, long long R,
                                 long long C, void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_absmax<__nv_bfloat16>(x, o, R, C, st)
                : launch_absmax<float>(x, o, R, C, st);
}

// codes (R, C) int8 from x (R, C) (x_bf16 selects bf16, else f32), rand
// (R, C) uint32 and row scales scale[R]; s <= 127. vec_io = 1 promises x,
// rand and codes 16-, 16- and 4-byte aligned (8-byte for bf16 x). All arrays
// contiguous. Returns the cudaError_t of the launch (0 = success).
extern "C" int stoch_quant_launch(const void* x, int x_bf16, const void* rand,
                                  const float* scale, void* codes, long long R,
                                  long long C, int s, int vec_io, void* stream) {
  const uint32_t* r = static_cast<const uint32_t*>(rand);
  int8_t* o = static_cast<int8_t*>(codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_quant<__nv_bfloat16>(x, r, scale, o, R, C, s, vec_io, st)
                : launch_quant<float>(x, r, scale, o, R, C, s, vec_io, st);
}

extern "C" const char* stoch_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
