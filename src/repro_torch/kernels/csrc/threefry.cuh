// threefry.cuh — the Threefry-2x32 hash (20 rounds) in uint32 registers, as
// jax.random runs it in partitionable mode: the device counterpart of
// repro_torch/prng.py · threefry2x32, which carries the same words in int64
// because torch on the CPU cannot shift uint32 (ROADMAP C3). CUDA C can, so
// here every word is a uint32 and each rotation one funnel shift.
//
// Users: csrc/threefry.cu (the plane kernel behind prng.bits / prng.uniform
// on the card), csrc/ds_quant.cu (B1's keyed entry) and csrc/quant_adamw.cu
// (B9 pass 2's keyed entry), which hash their rounding bits in registers.
//
// Integer work per element: 2 key adds, 20 rounds of (add, funnel shift,
// xor), 5 injections of two adds each (the constants k + i + 1 fold once per
// key), and the xor of the two words: 73 32-bit operations, of which the 41
// shifts and xors run only on the integer ALU pipe; ptxas may issue the adds
// as IMAD on the FMA pipe (chip_smoke.py's HASH_OPS, HASH_ALU_OPS).
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// the two output words of the hash of counter (x1, x2) under key (k1, k2):
// ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA); five groups of four rounds with the
// rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, each group ending
// x1 += ks[(i + 1) % 3], x2 += ks[(i + 2) % 3] + i + 1
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x1,
                                             uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl32(x2, kRot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// jax.random.bits' word for flat index i: the xor of the hash of the counter
// (hi, lo) = (i >> 32, i mod 2³²) — JAX's iota_2x32_shape counter
__device__ __forceinline__ uint32_t bits_at(uint32_t k1, uint32_t k2, unsigned long long i) {
  uint32_t x1 = static_cast<uint32_t>(i >> 32), x2 = static_cast<uint32_t>(i);
  threefry2x32(k1, k2, x1, x2);
  return x1 ^ x2;
}

// jax.random.uniform's f32 in [0, 1) from a bits word: the top 23 bits as
// the mantissa of a float in [1, 2), minus 1 (kernels/threefry.py · _unit_float)
__device__ __forceinline__ float unit_at(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.f;
}

}  // namespace
