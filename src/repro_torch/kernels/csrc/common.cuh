// common.cuh — small device and host helpers that several kernels share:
// the exact decode of int8 / int4 codes to f32 (csrc/qmm_core.cuh,
// csrc/qmv.cu, csrc/quant_adamw.cu), the max that keeps NaN
// (csrc/qmm_qout.cu, csrc/quant_adamw.cu, csrc/stoch_quant.cu), the
// last-block-to-arrive test of the in-launch merges (csrc/qmv.cu,
// csrc/quant_adamw.cu), the exact split of f32 into three bf16 pieces
// (csrc/qmm_t.cu, csrc/ssd.cu) and the per-device opt-in to more than 48 KB
// of dynamic shared memory (csrc/wgmma_tile.cuh's users, csrc/ssd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// byte q of w (an int8 code) as an exact float: 2²³ + (code + 128) built
// bit-wise by one byte permute, less 2²³ + 128 — integer and FADD pipes
// only (I2F runs at a quarter of their rate)
template <int Q>
__device__ __forceinline__ float int8_at(uint32_t w_xor80) {
  return __uint_as_float(__byte_perm(w_xor80, 0x4B000000u, 0x7440 | Q)) - 8388736.f;
}
// byte q of w, which holds a nibble 0..15 (offset-binary int4 code + 8)
template <int Q>
__device__ __forceinline__ float nib_at(uint32_t nibbles) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7440 | Q)) - 8388616.f;
}

// max that keeps a NaN from either side, as jnp.max and torch.amax do
// (fmaxf returns the operand that is not NaN); exact in any order
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// the last block of `slot` to arrive returns true (for every thread of the
// block), after setting the slot's counter back to 0: every block calls it
// once, after its partial is written, and `splits` blocks share the slot
__device__ __forceinline__ bool last_to_arrive(int* counters, int slot, int splits) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counters + slot, 1) == splits - 1;
    if (is_last) counters[slot] = 0;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// two f32 values → the bf16 pairs of their three pieces: hi = bf16(v),
// mid = bf16(v − hi), lo = bf16(v − hi − mid), each subtraction exact in
// f32 (kernels/qmm_t.py · split_bf16x3 is the same split in torch)
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(v0, hf.x), r1 = __fsub_rn(v1, hf.y);
  const __nv_bfloat162 md = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(md);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&md);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// > 48 KB of dynamic shared memory needs the opt-in, which holds for the
// current device only: opted_in keeps the devices that have it (one bit
// each; devices past 64 opt in each time)
template <typename F>
inline cudaError_t opt_in_smem(F* kernel, int bytes, unsigned long long& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (!(opted_in & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in |= bit;
  }
  return cudaSuccess;
}

}  // namespace
