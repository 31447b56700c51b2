// ssd_chunk_scan — Mamba2's SSD (state-space duality) chunk scan.
//
// Replaces: src/repro/kernels/ssd.py · ssd_chunk_scan (_ssd_kernel), the
// Pallas TPU kernel behind ops.ssd_chunked_kernel: the chunked dual form of
// the recurrence h_t = exp(dt_t·a)·h_{t-1} + dt_t·x_t ⊗ B_t, y_t = C_t·h_t,
// one launch per layer of a prefill.
//
// For each (batch, chunk), with the (P, N) state of every head carried
// across the chunks in f32:
//   cum      = cumsum(logdec)                     (L,)   per head
//   y_intra  = ((C·Bᵀ) ⊙ exp(cum_l − cum_m))·(dt ⊙ x),    m ≤ l only
//   y_inter  = (C · stateᵀ) ⊙ exp(cum_l)
//   state'   = state ⊙ exp(cum_L) + ((dt ⊙ x) ⊙ exp(cum_L − cum_m))ᵀ · B
// All arithmetic is f32; x, B and C are read as stored (bf16 or f32), dt
// and logdec are f32, y is written in x's dtype. The decay is masked before
// the exponential (above the diagonal cum_l − cum_m > 0 would overflow),
// and the cumulative sum runs in order, one add after another, as
// torch.cumsum does along a dimension that is not the innermost.
//
// What bounds it on an H100: at mamba2-780m's prefill (L 256, H 48, P 64,
// N 128) the work is the three contractions of every chunk, ~9.9 GFLOP a
// call on 4 × 1024 tokens against ~60 MB: the operations, on the f32 CUDA
// cores (67 TFLOP/s).
//
// What the design does about it: little yet — it is the simple form. One
// block of 256 threads per (batch, head) walks the chunks in order with
// the head's state in shared memory (P × N f32, 32 KB at full width), so
// the carry never leaves the SM. A chunk's rows go in tiles of 32: for an
// output tile the block stages C's rows, then, for each tile of earlier or
// equal rows, B's rows and dt ⊙ x, forms the 32 × 32 decayed score tile
// and accumulates it into a 32 × P register tile (8 p-lanes per row); the
// state update walks the chunk once more. Any chunk length works (L is not
// assumed ≤ 256, a power of two, or to fit in shared memory): the chunk's
// cum lives in a global scratch row per (batch, head). C·Bᵀ is recomputed
// by every head (G = 1 would let the heads share it), and nothing runs on
// the tensor cores; both are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;               // chunk rows per tile (l and m)
constexpr int kLanes = kThreads / kTile;  // 8 p-lanes per output row
constexpr int kMaxP = 64;               // head_dim the register tile holds
constexpr int kPerLane = kMaxP / kLanes;  // p = lane + 8·q, q < 8
constexpr int kStateRegs = 32;          // state entries per thread per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* x;              // x[b, c, l, h, p] at b·xsb + c·xsc + l·xsl + h·xsh + p
  long long xsb, xsc, xsl, xsh;
  const float* dt;            // (B, NC, L, H) contiguous
  const float* logdec;        // (B, NC, L, H) contiguous
  const void* bm;             // B[b, c, l, n] at b·bsb + c·bsc + l·bsl + n
  long long bsb, bsc, bsl;
  const void* cm;             // C[b, c, l, n] at b·csb + c·csc + l·csl + n
  long long csb, csc, csl;
  const float* init;          // (B, H, P, N) or null (zeros)
  void* y;                    // (B, NC, L, H, P) contiguous, x's dtype
  float* state;               // (B, H, P, N)
  float* cum;                 // (B, H, L) scratch
  int B, NC, L, H, P, N;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(Args a) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int L = a.L, H = a.H, P = a.P, N = a.N;
  const int NS = N + 1;                 // odd row stride: no bank conflicts
  float* S = sm;                        // P × NS   the carried state
  float* Ct = S + P * NS;               // kTile × NS   C rows of the l tile
  float* Bt = Ct + kTile * NS;          // kTile × NS   B rows of the m tile
  float* Xt = Bt + kTile * NS;          // kTile × P    dt ⊙ x (⊙ tail) of the m tile
  float* W = Xt + kTile * P;            // kTile × (kTile + 1)   decayed scores
  float* cl = W + kTile * (kTile + 1);  // cum of the l tile
  float* cmv = cl + kTile;              // cum (or tail decay) of the m tile
  float* stage = cmv + kTile;           // kThreads: the scan's staging
  const T* x = static_cast<const T*>(a.x);
  const T* bm = static_cast<const T*>(a.bm);
  const T* cm = static_cast<const T*>(a.cm);
  T* y = static_cast<T*>(a.y);
  float* cum = a.cum + ((long long)b * H + h) * L;
  const long long shead = ((long long)b * H + h) * P * N;

  for (int e = t; e < P * N; e += kThreads)
    S[(e / N) * NS + e % N] = a.init ? a.init[shead + e] : 0.f;

  const int i = t / kLanes;             // output row of the tile this thread owns
  const int lane = t % kLanes;
  for (int c = 0; c < a.NC; ++c) {
    const long long row0 = ((long long)b * a.NC + c) * L;  // (b, c, 0) in dt/logdec/y
    const T* xc = x + b * a.xsb + c * a.xsc + h * a.xsh;
    const T* bc = bm + b * a.bsb + c * a.bsc;
    const T* cc = cm + b * a.csb + c * a.csc;

    // 1. cum: the chunk's running sum of logdec, one add after another
    float carry = 0.f;
    for (int l0 = 0; l0 < L; l0 += kThreads) {
      if (l0 + t < L) stage[t] = a.logdec[(row0 + l0 + t) * H + h];
      __syncthreads();
      if (t == 0) {
        const int cnt = min(kThreads, L - l0);
        for (int k = 0; k < cnt; ++k) {
          carry += stage[k];
          cum[l0 + k] = carry;
        }
      }
      __syncthreads();
    }
    const float cum_last = cum[L - 1];

    // 2. y, one tile of kTile rows at a time
    for (int l0 = 0; l0 < L; l0 += kTile) {
      for (int e = t; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e % N;
        Ct[r * NS + n] = l0 + r < L ? to_f32(cc[(long long)(l0 + r) * a.csl + n]) : 0.f;
      }
      if (t < kTile) cl[t] = l0 + t < L ? cum[l0 + t] : 0.f;
      __syncthreads();

      float inter[kPerLane], intra[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) inter[q] = intra[q] = 0.f;
      // y_inter = (C_l · state) ⊙ exp(cum_l)
      for (int n = 0; n < N; ++n) {
        const float cv = Ct[i * NS + n];
#pragma unroll
        for (int q = 0; q < kPerLane; ++q)
          if (lane + kLanes * q < P) inter[q] = fmaf(cv, S[(lane + kLanes * q) * NS + n], inter[q]);
      }
      const float dl = expf(cl[i]);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) inter[q] *= dl;

      // y_intra over the m tiles at or before this one
      for (int m0 = 0; m0 <= l0; m0 += kTile) {
        __syncthreads();  // the previous m tile's readers are done
        for (int e = t; e < kTile * N; e += kThreads) {
          const int j = e / N, n = e % N;
          Bt[j * NS + n] = m0 + j < L ? to_f32(bc[(long long)(m0 + j) * a.bsl + n]) : 0.f;
        }
        for (int e = t; e < kTile * P; e += kThreads) {
          const int j = e / P, p = e % P;
          const int m = m0 + j;
          Xt[j * P + p] = m < L ? to_f32(xc[(long long)m * a.xsl + p]) * a.dt[(row0 + m) * H + h]
                                : 0.f;
        }
        if (t < kTile) cmv[t] = m0 + t < L ? cum[m0 + t] : 0.f;
        __syncthreads();
        {
          const int j = t % kTile;  // a warp per score row, a lane per column
          for (int r = t / kTile; r < kTile; r += kThreads / kTile) {
            const int l = l0 + r, m = m0 + j;
            float w = 0.f;
            if (m <= l && l < L) {  // masked before the exponential
              float s = 0.f;
              for (int n = 0; n < N; ++n) s = fmaf(Ct[r * NS + n], Bt[j * NS + n], s);
              w = s * expf(cl[r] - cmv[j]);
            }
            W[r * (kTile + 1) + j] = w;
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          const float w = W[i * (kTile + 1) + j];
#pragma unroll
          for (int q = 0; q < kPerLane; ++q)
            if (lane + kLanes * q < P) intra[q] = fmaf(w, Xt[j * P + lane + kLanes * q], intra[q]);
        }
      }
      if (l0 + i < L) {
        T* yr = y + ((row0 + l0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q)
          if (lane + kLanes * q < P) store(yr + lane + kLanes * q, intra[q] + inter[q]);
      }
      __syncthreads();  // Ct and cl are restaged by the next tile
    }

    // 3. state' = state ⊙ exp(cum_L) + Σ_m ((dt ⊙ x)_m ⊙ exp(cum_L − cum_m)) B_mᵀ
    const float dec_last = expf(cum_last);
    for (int e0 = 0; e0 < P * N; e0 += kThreads * kStateRegs) {
      float bx[kStateRegs];
#pragma unroll
      for (int k = 0; k < kStateRegs; ++k) bx[k] = 0.f;
      for (int m0 = 0; m0 < L; m0 += kTile) {
        __syncthreads();
        if (t < kTile) cmv[t] = m0 + t < L ? expf(cum_last - cum[m0 + t]) : 0.f;
        for (int e = t; e < kTile * N; e += kThreads) {
          const int j = e / N, n = e % N;
          Bt[j * NS + n] = m0 + j < L ? to_f32(bc[(long long)(m0 + j) * a.bsl + n]) : 0.f;
        }
        __syncthreads();
        for (int e = t; e < kTile * P; e += kThreads) {
          const int j = e / P, p = e % P;
          const int m = m0 + j;
          Xt[j * P + p] = m < L ? to_f32(xc[(long long)m * a.xsl + p]) * a.dt[(row0 + m) * H + h]
                                      * cmv[j]
                                : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kStateRegs; ++k) {
          const int e = e0 + k * kThreads + t;
          if (e < P * N) {
            const int p = e / N, n = e % N;
            float s = bx[k];
            for (int j = 0; j < kTile; ++j) s = fmaf(Xt[j * P + p], Bt[j * NS + n], s);
            bx[k] = s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kStateRegs; ++k) {
        const int e = e0 + k * kThreads + t;
        if (e < P * N) {
          float* sp = S + (e / N) * NS + e % N;
          *sp = *sp * dec_last + bx[k];
        }
      }
    }
    __syncthreads();
  }
  for (int e = t; e < P * N; e += kThreads) a.state[shead + e] = S[(e / N) * NS + e % N];
}

template <typename T>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_kernel<T><<<dim3(a.H, a.B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (B, NC, L, H, P) bf16 (x_bf16 = 1) or f32 at element strides
// (xsb, xsc, xsl, xsh, 1); dt, logdec (B, NC, L, H) f32 contiguous; b and c
// (B, NC, L, N) in x's dtype at strides (·sb, ·sc, ·sl, 1); init (B, H, P,
// N) f32 or null; y (B, NC, L, H, P) in x's dtype and state (B, H, P, N) f32,
// both contiguous; cum a (B, H, L) f32 scratch. P ≤ 64; a state too large
// for shared memory fails the launch. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int ssd_chunk_scan_launch(const void* x, int x_bf16, long long xsb, long long xsc,
                                     long long xsl, long long xsh, const float* dt,
                                     const float* logdec, const void* bm, long long bsb,
                                     long long bsc, long long bsl, const void* cm,
                                     long long csb, long long csc, long long csl,
                                     const float* init, void* y, float* state, float* cum,
                                     int B, int NC, int L, int H, int P, int N, void* stream) {
  if (P > kMaxP || P < 1 || N < 1 || L < 1) return cudaErrorInvalidValue;
  const Args a{x, xsb, xsc, xsl, xsh, dt, logdec, bm, bsb, bsc, bsl, cm, csb, csc, csl,
               init, y, state, cum, B, NC, L, H, P, N};
  const size_t ns = N + 1;
  const size_t smem = 4 * (P * ns + 2 * kTile * ns + kTile * P + kTile * (kTile + 1) +
                           2 * kTile + kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, smem, st) : launch<float>(a, smem, st);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
