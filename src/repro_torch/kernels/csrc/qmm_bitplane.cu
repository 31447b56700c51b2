// qmm_bitplane — fused bit-plane (MLWeaving) dequantize-matmul.
//
// Replaces: src/repro/kernels/qmm_bitplane.py · qmm_bitplane
// (_qmm_bitplane_kernel), the Pallas TPU kernel behind every bitplane
// QTensor-weighted layers.dense of the any-precision serving path.
//
// Computes y[M, N] = x[M, K] · decode(planes[P, K, W]) ⊙ scale[N] in f32,
// P = k + 1 ≤ 9 and W = ⌈N/32⌉. Plane 0 holds the sign, planes 1..k the
// magnitude MSB first; bit j of word w of a plane row is column 32·w + j
// (the tail word is zero-padded). decode = sign · mag · 2^−k · scale, so a
// slice_planes(k) view is served by passing its first k + 1 planes.
//
// What bounds it on an H100: on the decode path M is the number of slots
// (4), or the speculative verify window (4 slots × 4 rows = 16), so this is
// a weight-streaming GEMV: 2·M·K·N operations against K·N·P/8 code bytes —
// far below the card's ~295 operations per byte, so the bound is the code
// bytes over HBM bandwidth, linear in the planes served (an 8-bit artifact
// streams 9/8 bytes per weight, its 4-bit view 5/8).
//
// What the design does about it: each thread owns one 32-column word of
// every plane row, so a warp reads 32 consecutive words (128 bytes) of each
// plane, and every code byte is read once per block row of x. The integer
// ±mag is rebuilt in registers and Σ x·(±mag) accumulates in f32 — exact
// products of integer codes — with scale·2^−k applied once after the
// contraction. Eight warps stride the K rows of a block, and the grid
// splits K (gridDim.z) so that N = 256 (the k/v projections) still puts
// blocks on most SMs; split-K partials land in a scratch plane that a
// second small kernel sums in a fixed order. The K split depends only on
// (K, N), and each row of x is accumulated on its own, so an output row is
// computed by the same operations whatever M is: a decode step (M = 4) and
// the verify window (M = 16) agree bit for bit. Ragged M, K and N are masked
// inside the kernel; nothing is padded. Prefill (M = 128) reuses the kernel
// with one block row per 4 rows of x; bf16 tensor-core tiles (the codes are
// exact in bf16 and the scale comes after the contraction) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 4;            // rows of x per block
constexpr int kKSub = 128;        // k rows of x staged in shared memory at a time
constexpr int kBN = 32 * 32;      // columns per block: one 32-column word per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT, int P>
__global__ void __launch_bounds__(kThreads)
qmm_bitplane_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ planes,
                    const float* __restrict__ scale, float* __restrict__ dst,
                    int M, int K, int N, int W, int k_chunk, float post) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane;  // this thread's word column
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const size_t plane_stride = (size_t)K * W;

  __shared__ float xs[kBM][kKSub];
  __shared__ float red[kWarps][32][33];  // [warp][bit j][lane], padded: no bank conflicts

  float acc[kBM][32];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[m][j] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += kKSub) {
    const int kn = min(kKSub, k_end - ks);
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kKSub; i += kThreads) {
      const int m = i / kKSub, kk = i % kKSub;
      xs[m][kk] = (m0 + m < M && kk < kn)
                      ? to_f32(x[(size_t)(m0 + m) * K + ks + kk]) : 0.f;
    }
    __syncthreads();
    if (w < W) {
      for (int kk = warp; kk < kn; kk += kWarps) {
        const uint32_t* row = planes + (size_t)(ks + kk) * W + w;
        uint32_t word[P];
#pragma unroll
        for (int p = 0; p < P; ++p) word[p] = __ldg(row + p * plane_stride);
        float xv[kBM];
#pragma unroll
        for (int m = 0; m < kBM; ++m) xv[m] = xs[m][kk];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          int mag = 0;  // exact integer < 2^8, MSB plane first
#pragma unroll
          for (int p = 1; p < P; ++p) mag = (mag << 1) | static_cast<int>((word[p] >> j) & 1u);
          const float v = ((word[0] >> j) & 1u) ? -static_cast<float>(mag)
                                                : static_cast<float>(mag);
#pragma unroll
          for (int m = 0; m < kBM; ++m) acc[m][j] = fmaf(xv[m], v, acc[m][j]);
        }
      }
    }
  }

  // cross-warp reduction, one x row at a time, in a fixed order; without a
  // K split the scale is applied here, else by the reduce kernel
  float* out = dst + (size_t)blockIdx.z * M * N;
  const bool scaled = gridDim.z == 1;
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; ++j) red[warp][j][lane] = acc[m][j];
    __syncthreads();
    if (m0 + m < M) {
      for (int c = threadIdx.x; c < kBN; c += kThreads) {
        const int n = blockIdx.x * kBN + c;  // c = lane·32 + j
        if (n < N) {
          float s = 0.f;
#pragma unroll
          for (int ww = 0; ww < kWarps; ++ww) s += red[ww][c & 31][c >> 5];
          out[(size_t)(m0 + m) * N + n] = scaled ? s * (scale[n] * post) : s;
        }
      }
    }
  }
}

__global__ void splitk_reduce_scale(const float* __restrict__ part,
                                    const float* __restrict__ scale,
                                    float* __restrict__ out, int splits, int N,
                                    long long mn, float post) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * mn + i];
  out[i] = s * (scale[i % N] * post);
}

template <typename XT, int P>
cudaError_t launch(const void* x, const uint32_t* planes, const float* scale,
                   float* out, float* part, int M, int K, int N, int splits,
                   cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const int k_chunk = (K + splits - 1) / splits;
  const float post = 1.0f / static_cast<float>(1 << (P - 1));  // 2^−k, exact
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  float* dst = splits > 1 ? part : out;
  qmm_bitplane_kernel<XT, P><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), planes, scale, dst, M, K, N, W, k_chunk, post);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  splitk_reduce_scale<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, scale, out, splits, N, mn, post);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_planes(const void* x, const uint32_t* planes, int n_planes,
                          const float* scale, float* out, float* part, int M,
                          int K, int N, int splits, cudaStream_t s) {
  switch (n_planes) {
    case 1: return launch<XT, 1>(x, planes, scale, out, part, M, K, N, splits, s);
    case 2: return launch<XT, 2>(x, planes, scale, out, part, M, K, N, splits, s);
    case 3: return launch<XT, 3>(x, planes, scale, out, part, M, K, N, splits, s);
    case 4: return launch<XT, 4>(x, planes, scale, out, part, M, K, N, splits, s);
    case 5: return launch<XT, 5>(x, planes, scale, out, part, M, K, N, splits, s);
    case 6: return launch<XT, 6>(x, planes, scale, out, part, M, K, N, splits, s);
    case 7: return launch<XT, 7>(x, planes, scale, out, part, M, K, N, splits, s);
    case 8: return launch<XT, 8>(x, planes, scale, out, part, M, K, N, splits, s);
    case 9: return launch<XT, 9>(x, planes, scale, out, part, M, K, N, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (M, N) f32 = x (M, K) · decode(planes (n_planes, K, ⌈N/32⌉) uint32,
// scale (N,) f32). x_bf16 selects the x type (else f32); part is a
// (splits, M, N) f32 scratch plane when splits > 1. Returns the cudaError_t
// of the launches (0 = success).
extern "C" int qmm_bitplane_launch(const void* x, int x_bf16, const void* planes,
                                   int n_planes, const float* scale, float* out,
                                   float* part, int M, int K, int N, int splits,
                                   void* stream) {
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_planes<__nv_bfloat16>(x, p, n_planes, scale, out, part, M, K, N, splits, s);
  return launch_planes<float>(x, p, n_planes, scale, out, part, M, K, N, splits, s);
}

extern "C" const char* qmm_bitplane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
