// qmv — int8 code plane times an f32 vector: out[r] = Σ_c codes[r, c] · v[c].
//
// Replaces: src/repro/kernels/qmm.py · qmv (_qmv_kernel), the Pallas TPU
// kernel behind ops.int8_matvec, four calls of which build the
// double-sampling gradient q₁ᵀ(q₂x − b) straight from the code planes.
//
// The code plane is read through its strides, so the transposed view
// codes.T of a row-major (B, n) plane — the two q·ᵀr products of the
// gradient — needs no copy. Codes widen to f32 exactly by common.cuh's
// int8_at (a byte permute and an FADD: I2F runs at a quarter of their
// rate, and the transposed view converts 64 codes a thread) and
// accumulate in f32.
//
// What bounds it on an H100: 2·R·C operations against R·C code bytes —
// the bytes over HBM bandwidth; on the linear path (R·C = 16 × 5000 and
// 16 × 90, and their transposes) one launch and one round trip to memory.
// A call is ONE launch at every shape, and every thread issues all of its
// loads (codes and v) before its first FMA, so a block waits on memory
// once. Two layouts, one file; qmv.plan (kernels/qmv.py) picks the layout,
// the load width, the loads per thread and the split, and this file takes
// them unchanged:
//   rows — the contiguous axis is C: a block of kThreads per output row
//          (per chunk of it) loads `U` vectors of `W` codes per thread (W
//          16, 8 or 4 bytes where the row's address and stride allow it, 1
//          otherwise), with the matching float4s of v, then reduces with
//          shuffles and the four warp sums in order by one thread;
//   cols — the contiguous axis is R (the transposed view) and R is long
//          (at most 256 rows, a block per row is one wave and faster): a
//          thread owns K consecutive outputs (K 4 where the plane's
//          alignment allows a 32-bit load to cover four rows of a column,
//          2 or 1 otherwise) and walks `U` columns, unrolled, all loads
//          issued up front.
// Where one step of a block does not cover C (rows) or C is wider than
// 16 columns (cols; qmv.MAX_COLS_STEP), C splits into chunks along
// gridDim.y. Each chunk's
// partial lands in a workspace, and the last block to arrive at a row
// (rows) or row tile (cols) — an arrival counter bumped by atomicAdd after
// __threadfence — sums the partials in chunk order and sets the counter
// back to 0, so the counters, zeroed once when allocated, are 0 between
// calls: no memset and no second launch per call, and results are the
// same from run to run. Ragged R and C are masked; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const int8_t* codes;  // codes[r, c] at r·sr + c·sc
  long long sr, sc;
  const float* v;       // (C,) contiguous, 16-byte aligned
  float* out;           // (R,)
  float* part;          // (splits, R) partials when splits > 1
  int* counters;        // one per row (rows) or row tile (cols), 0 between calls
  int R, C, splits, chunk;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int W> struct Vec;
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<16> { using T = uint4; };

__device__ __forceinline__ uint32_t word(uint32_t q, int) { return q; }
__device__ __forceinline__ uint32_t word(uint2 q, int i) { return i ? q.y : q.x; }
__device__ __forceinline__ uint32_t word(uint4 q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// the last block of `slot` to arrive returns true (for every thread of the
// block), after setting the slot's counter back to 0
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

// rows: block (r, z) sums codes[r, chunk z] · v[chunk z]; W bytes a load
template <int W, int U>
__global__ void __launch_bounds__(kThreads) qmv_rows(Args a) {
  const int r = blockIdx.x, z = blockIdx.y, t = threadIdx.x;
  const int c0 = z * a.chunk, c1 = min(a.C, c0 + a.chunk);
  const int8_t* row = a.codes + (long long)r * a.sr;
  float acc = 0.f;
  if constexpr (W == 1) {
    int8_t q[U];
    float vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kThreads + t;
      q[u] = c < c1 ? __ldg(row + (long long)c * a.sc) : 0;
      vv[u] = c < c1 ? __ldg(a.v + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc = fmaf(int8_at<0>(static_cast<uint8_t>(q[u]) ^ 0x80808080u), vv[u], acc);
  } else {
    using T = typename Vec<W>::T;
    T q[U];
    float4 vv[U][W / 4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + W * (u * kThreads + t);
      if (c + W <= c1) {
        q[u] = __ldg(reinterpret_cast<const T*>(row + c));
#pragma unroll
        for (int k = 0; k < W / 4; ++k)
          vv[u][k] = __ldg(reinterpret_cast<const float4*>(a.v + c) + k);
      } else {
        q[u] = T{};
#pragma unroll
        for (int k = 0; k < W / 4; ++k) vv[u][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint32_t w = word(q[u], k) ^ 0x80808080u;
        acc = fmaf(int8_at<0>(w), vv[u][k].x, acc);
        acc = fmaf(int8_at<1>(w), vv[u][k].y, acc);
        acc = fmaf(int8_at<2>(w), vv[u][k].z, acc);
        acc = fmaf(int8_at<3>(w), vv[u][k].w, acc);
      }
    // the last chunk's ragged end: fewer than W codes
    const int tail = c0 + (c1 - c0) / W * W;
    if (tail + t < c1) acc = fmaf(static_cast<float>(row[tail + t]), __ldg(a.v + tail + t), acc);
  }
  __shared__ float wsum[kThreads / 32];
  acc = warp_sum(acc);
  if ((t & 31) == 0) wsum[t >> 5] = acc;
  __syncthreads();
  float s = 0.f;
  if (t == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += wsum[w];
    if (a.splits == 1) a.out[r] = s;
    else a.part[(long long)z * a.R + r] = s;
  }
  if (a.splits == 1 || !last_to_arrive(a.counters, r, a.splits)) return;
  if (t == 0) {
    float tot = 0.f;
    for (int k = 0; k < a.splits; ++k) tot += __ldcg(a.part + (long long)k * a.R + r);
    a.out[r] = tot;
  }
}

// cols: block (tile, z) sums rows [tile·kThreads·K, +kThreads·K) over chunk
// z; thread t owns the K rows r0 = (tile·kThreads + t)·K …
template <int K, int U>
__global__ void __launch_bounds__(kThreads) qmv_cols(Args a) {
  static_assert(K == 1 || K == 2 || K == 4, "a thread owns 1, 2 or 4 rows");
  const int z = blockIdx.y, t = threadIdx.x;
  const int r0 = (blockIdx.x * kThreads + t) * K;
  const int c0 = z * a.chunk, c1 = min(a.C, c0 + a.chunk);
  const int8_t* p = a.codes + r0;  // sr == 1
  const bool whole = r0 + K <= a.R;
  uint32_t q[U];
  float vv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u;
    const int8_t* src = p + (long long)c * a.sc;
    q[u] = 0u;
    vv[u] = 0.f;
    if (c < c1 && r0 < a.R) {
      if (K == 4 && whole) {
        q[u] = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else if (K == 2 && whole) {
        q[u] = __ldg(reinterpret_cast<const uint16_t*>(src));
      } else {
        for (int k = 0; k < K && r0 + k < a.R; ++k)
          q[u] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + k))) << (8 * k);
      }
      vv[u] = __ldg(a.v + c);
    }
  }
  float acc[K] = {};
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t w = q[u] ^ 0x80808080u;
    acc[0] = fmaf(int8_at<0>(w), vv[u], acc[0]);
    if constexpr (K > 1) acc[1] = fmaf(int8_at<1>(w), vv[u], acc[1]);
    if constexpr (K > 2) {
      acc[2] = fmaf(int8_at<2>(w), vv[u], acc[2]);
      acc[3] = fmaf(int8_at<3>(w), vv[u], acc[3]);
    }
  }
  if (a.splits == 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (r0 + k < a.R) a.out[r0 + k] = acc[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (r0 + k < a.R) a.part[(long long)z * a.R + r0 + k] = acc[k];
  if (!last_to_arrive(a.counters, blockIdx.x, a.splits)) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (r0 + k >= a.R) break;
    float tot = 0.f;
    for (int j = 0; j < a.splits; ++j) tot += __ldcg(a.part + (long long)j * a.R + r0 + k);
    a.out[r0 + k] = tot;
  }
}

template <typename Kernel>
cudaError_t go(Kernel kernel, dim3 grid, const Args& a, cudaStream_t st) {
  kernel<<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int W>
cudaError_t rows(int unroll, dim3 grid, const Args& a, cudaStream_t st) {
  switch (unroll) {
    case 1: return go(qmv_rows<W, 1>, grid, a, st);
    case 2: return go(qmv_rows<W, 2>, grid, a, st);
    case 4: return go(qmv_rows<W, 4>, grid, a, st);
    case 8: return go(qmv_rows<W, 8>, grid, a, st);
  }
  return cudaErrorInvalidValue;
}

template <int K>
cudaError_t cols(int unroll, dim3 grid, const Args& a, cudaStream_t st) {
  switch (unroll) {
    case 1: return go(qmv_cols<K, 1>, grid, a, st);
    case 2: return go(qmv_cols<K, 2>, grid, a, st);
    case 4: return go(qmv_cols<K, 4>, grid, a, st);
    case 8: return go(qmv_cols<K, 8>, grid, a, st);
    case 16: return go(qmv_cols<K, 16>, grid, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out (R,) f32 = codes (R, C) int8, read at element strides (sr, sc), · v
// (C,) f32 (contiguous, 16-byte aligned), as qmv.plan laid it out: layout 0
// (rows) or 1 (cols, sr == 1); width the code bytes a load (rows: 1, 4, 8,
// 16 with sc == 1 and the row addresses that aligned; cols: the rows a
// thread owns, 1, 2, 4, with the column addresses that aligned); unroll the
// loads (rows) or columns (cols) per thread; C in `splits` chunks of
// `chunk` columns (a multiple of the rows width). part (splits, R) f32 and
// counters (R for rows, the row tiles for cols) int32, all 0, when
// splits > 1. One launch; returns its cudaError_t (0 = success).
extern "C" int qmv_launch(const void* codes, long long sr, long long sc, const float* v,
                          float* out, float* part, int* counters, int R, int C, int layout,
                          int width, int unroll, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const int8_t*>(codes), sr, sc, v, out, part, counters,
               R, C, splits, chunk};
  if (R < 1 || C < 1 || splits < 1 || splits > 65535 || (long long)splits * chunk < C)
    return cudaErrorInvalidValue;
  if (layout == 0) {
    const dim3 grid(R, splits);
    switch (width) {
      case 1: return rows<1>(unroll, grid, a, st);
      case 4: return rows<4>(unroll, grid, a, st);
      case 8: return rows<8>(unroll, grid, a, st);
      case 16: return rows<16>(unroll, grid, a, st);
    }
  } else if (layout == 1) {
    const dim3 grid((R + kThreads * width - 1) / (kThreads * width), splits);
    switch (width) {
      case 1: return cols<1>(unroll, grid, a, st);
      case 2: return cols<2>(unroll, grid, a, st);
      case 4: return cols<4>(unroll, grid, a, st);
    }
  }
  return cudaErrorInvalidValue;
}


extern "C" const char* qmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
