// threefry — one launch per prng plane: jax.random.bits / jax.random.uniform
// of one key, or of each of K keys, over the counters start .. start + n − 1.
//
// Replaces: no TPU kernel. The reference draws its planes with XLA's
// threefry2x32 outside any Pallas kernel; the port's int64 hash
// (repro_torch/kernels/threefry.py · threefry2x32, torch on int64 words, as torch
// cannot shift uint32 on the CPU, ROADMAP C3) costs one elementwise launch
// per add, shift, mask, or and xor — 174 launches for one plane — and held
// 0.912 of the all-8-bit training step's device time. threefry_plane there
// (behind prng.bits and prng.uniform) launches this kernel for every plane
// made on the card; the int64 path stays the CPU path and this kernel's plain
// version.
//
// Output j (K keys: key j / n, counter start + j mod n; the batched-key
// layout of threefry.hash_counts, (*key batch, *shape) flattened) is one of
//   int32: the bits word, as int32 (prng.bits(..., dtype=int32)),
//   int64: the bits word zero-extended (prng.bits's default int64),
//   f32:   unit_at(bits), jax.random.uniform's [0, 1) (prng.uniform).
// Bit-exact with the int64 path: uint32 adds wrap as the int64 path's masks
// do, and a funnel shift is the masked (x << r) | (x >> (32 − r)).
//
// What bounds it on an H100: the hash's integer work. Each element takes
// 73 32-bit operations (csrc/threefry.cuh) against 4 bytes written
// (8 for int64). 41 of them, the funnel shifts and xors, run only on the
// integer ALU pipe, at 64 results per clock per SM (the CUDA guide's
// throughput table, compute capability 9.0); ptxas issues most of the 32
// adds as IMAD on the FMA pipe, another 64 a clock. So the least time per
// 604M elements (a gemma-2b gate/up leaf) is ~1.5 ms of integer issue at
// 1980 MHz, against 0.72 ms of HBM writes. The design keeps the integer
// pipes fed: a grid-stride loop over the flat output, each thread hashing
// kPer counters at a stride of the grid (independent hash chains to
// interleave), writes coalesced across the warp. Batched keys track (key,
// counter) incrementally, with no division in the loop; a single key is
// passed by value and reads no memory at all.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // counters in flight per thread
enum { OUT_I32 = 0, OUT_I64 = 1, OUT_F32 = 2 };

template <int OUT>
__device__ __forceinline__ void store(void* out, long long j, uint32_t b) {
  if constexpr (OUT == OUT_I32) {
    static_cast<uint32_t*>(out)[j] = b;
  } else if constexpr (OUT == OUT_I64) {
    static_cast<long long*>(out)[j] = static_cast<long long>(b);
  } else {
    static_cast<float*>(out)[j] = unit_at(b);
  }
}

// keys: K (key, word) pairs as int64 holding uint32 values, or nullptr for the
// single key (k1, k2); total = K · n outputs
template <int OUT, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
threefry_plane(const long long* __restrict__ keys, uint32_t k1, uint32_t k2,
               unsigned long long start, long long n, long long total,
               void* __restrict__ out) {
  const long long step = (long long)gridDim.x * kThreads;
  long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= total) return;
  // the (key, counter) of j, advanced by step each turn: dk keys, di counters
  long long key = 0, i = j, dk = 0, di = step;
  if constexpr (BATCHED) {
    key = j / n;
    i = j - key * n;
    dk = step / n;
    di = step - dk * n;
  }
  for (; j < total; j += kPer * step) {
    uint32_t w[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      uint32_t a = k1, b = k2;
      if constexpr (BATCHED) {
        const long long kk = j + u * step < total ? key : 0;  // past the end: unused
        a = static_cast<uint32_t>(keys[2 * kk]);
        b = static_cast<uint32_t>(keys[2 * kk + 1]);
      }
      w[u] = bits_at(a, b, start + static_cast<unsigned long long>(i));
      i += di;
      if constexpr (BATCHED) {
        key += dk;
        if (i >= n) {
          i -= n;
          ++key;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (j + u * step < total) store<OUT>(out, j + u * step, w[u]);
  }
}

template <int OUT>
cudaError_t launch(const long long* keys, uint32_t k1, uint32_t k2, long long nkeys,
                   unsigned long long start, long long n, void* out, cudaStream_t stream) {
  const long long total = nkeys * n;
  long long blocks = (total + kThreads * kPer - 1) / (kThreads * kPer);
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  if (blocks < 1) blocks = 1;
  if (keys != nullptr)
    threefry_plane<OUT, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        keys, 0u, 0u, start, n, total, out);
  else
    threefry_plane<OUT, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        nullptr, k1, k2, start, n, total, out);
  return cudaGetLastError();
}

}  // namespace

// out (nkeys · n) of kind out_kind (0 int32 bits, 1 int64 bits, 2 f32
// uniform): the hash of counters start .. start + n − 1 under each key.
// keys (nkeys, 2) int64 on the device, or nullptr for the one key (k1, k2)
// (nkeys 1). Returns the cudaError_t of the launch (0 = success).
extern "C" int threefry_plane_launch(const void* keys, unsigned int k1, unsigned int k2,
                                     long long nkeys, unsigned long long start, long long n,
                                     int out_kind, void* out, void* stream) {
  const long long* kp = static_cast<const long long*>(keys);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nkeys <= 0 || n <= 0) return cudaSuccess;
  switch (out_kind) {
    case OUT_I32: return launch<OUT_I32>(kp, k1, k2, nkeys, start, n, out, st);
    case OUT_I64: return launch<OUT_I64>(kp, k1, k2, nkeys, start, n, out, st);
    case OUT_F32: return launch<OUT_F32>(kp, k1, k2, nkeys, start, n, out, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
