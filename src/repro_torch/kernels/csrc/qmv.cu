// qmv — int8 code plane times an f32 vector: out[r] = Σ_c codes[r, c] · v[c].
//
// Replaces: src/repro/kernels/qmm.py · qmv (_qmv_kernel), the Pallas TPU
// kernel behind ops.int8_matvec, four calls of which build the
// double-sampling gradient q₁ᵀ(q₂x − b) straight from the code planes.
//
// The code plane is read through its strides, so the transposed view
// codes.T of a row-major (B, n) plane — the two q·ᵀr products of the
// gradient — needs no copy. Codes widen to f32 and accumulate in f32.
//
// What bounds it on an H100: 2·R·C operations against R·C code bytes —
// the bytes over HBM bandwidth; on the linear path (R·C = 16 × 5000) the
// launch. The shapes there are extreme in both directions, (16, 5000) and
// (5000, 16), so one warp per output row would put 16 warps on 132 SMs.
// Two layouts, one file:
//   rows — the contiguous axis is C: a warp per output row walks a chunk of
//          columns (one 32-bit word of 4 codes per lane where aligned) and
//          reduces with shuffles in a fixed order;
//   cols — the contiguous axis is R (the transposed view): a thread per
//          output row walks a chunk of columns, neighbouring threads on
//          neighbouring bytes.
// The grid splits C into chunks (gridDim.y) so that a few hundred blocks
// are in flight; per-chunk partials land in a scratch plane that a second
// launch sums in chunk order, so results are the same from run to run.
// Ragged R and C are masked in the kernels; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
qmv_rows(const int8_t* __restrict__ codes, long long sr, long long sc,
         const float* __restrict__ v, float* __restrict__ dst, int R, int C,
         int chunk, int vec) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps leave together: no barrier below
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const int8_t* row = codes + (long long)r * sr;
  float acc = 0.f;
  if (vec) {  // sc == 1, row and chunk starts 4-byte aligned
    int c = c0 + 4 * lane;
    for (; c + 3 < c1; c += 128) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + c));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc = fmaf(static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xFFu)),
                   __ldg(v + c + k), acc);
    }
    for (int k = c; k < min(c + 4, c1); ++k)
      acc = fmaf(static_cast<float>(row[k]), __ldg(v + k), acc);
  } else {
    for (int c = c0 + lane; c < c1; c += 32)
      acc = fmaf(static_cast<float>(row[(long long)c * sc]), __ldg(v + c), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) dst[(long long)blockIdx.y * R + r] = acc;
}

__global__ void __launch_bounds__(kThreads)
qmv_cols(const int8_t* __restrict__ codes, long long sr, long long sc,
         const float* __restrict__ v, float* __restrict__ dst, int R, int C,
         int chunk) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(C, c0 + chunk);
  const int8_t* p = codes + (long long)r * sr;
  float acc = 0.f;
  for (int c = c0; c < c1; ++c)
    acc = fmaf(static_cast<float>(p[(long long)c * sc]), __ldg(v + c), acc);
  dst[(long long)blockIdx.y * R + r] = acc;
}

__global__ void chunk_reduce(const float* __restrict__ part, float* __restrict__ out,
                             int splits, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * R + r];
  out[r] = s;
}

}  // namespace

// out (R,) f32 = codes (R, C) int8, read at element strides (sr, sc), · v (C,)
// f32. cols = 1 selects the thread-per-row layout (for sr == 1), else the
// warp-per-row one; vec = 1 (rows only) reads 4 codes per lane and needs
// sc == 1 and 4-byte aligned rows and chunks. C splits into `splits` chunks
// of `chunk` columns; part is a (splits, R) f32 scratch plane when
// splits > 1. Returns the cudaError_t of the launches (0 = success).
extern "C" int qmv_launch(const void* codes, long long sr, long long sc,
                          const float* v, float* out, float* part, int R, int C,
                          int cols, int vec, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* dst = splits > 1 ? part : out;
  if (cols) {
    dim3 grid((R + kThreads - 1) / kThreads, splits);
    qmv_cols<<<grid, kThreads, 0, st>>>(c, sr, sc, v, dst, R, C, chunk);
  } else {
    dim3 grid((R + kWarps - 1) / kWarps, splits);
    qmv_rows<<<grid, kThreads, 0, st>>>(c, sr, sc, v, dst, R, C, chunk, vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  chunk_reduce<<<(R + 255) / 256, 256, 0, st>>>(part, out, splits, R);
  return cudaGetLastError();
}

extern "C" const char* qmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
