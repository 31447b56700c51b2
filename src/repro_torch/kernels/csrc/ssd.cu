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
// What bounds it on an H100: at mamba2-780m's prefill (B 4, 4 chunks of L
// 256, H 48, P 64, N 128) the three contractions of every chunk, ~9.8
// GFLOP a call with C·Bᵀ once and the causal halves only, against ~60 MB:
// on the bf16 tensor cores (989 TFLOP/s) the bytes, 0.018 ms; the tensor-
// core core below multiplies its f32 operands in three bf16 pieces, so
// its own floor is ~29 GFLOP, 0.030 ms. Two cores, picked by x's dtype
// alone (kernels/ssd.py · plan):
//
// SIMT (f32 x; the f32 consistency check's, its numbers the first port's).
// One block of 256 threads per (batch, head) walks the chunks in order
// with the head's state in shared memory (P × N f32, 32 KB at full width),
// so the carry never leaves the SM. A chunk's rows go in tiles of 32: for
// an output tile the block stages C's rows, then, for each tile of earlier
// or equal rows, B's rows and dt ⊙ x, forms the 32 × 32 decayed score tile
// and accumulates it into a 32 × P register tile (8 p-lanes per row); the
// state update walks the chunk once more. Any chunk length works: the
// chunk's cum lives in a global scratch row per (batch, head). All on the
// f32 CUDA cores (67 TFLOP/s).
//
// Tensor cores (bf16 x, B and C: both served prefills), chunk-parallel in
// three launches of one call, the sequential form's arithmetic:
//   1. ssd_tc_state, a block per (batch, chunk, head): cum in order, then
//      bx_c = (dt ⊙ x ⊙ tail)ᵀ · B, which does not depend on the state;
//   2. ssd_tc_carry, a thread per state entry pair: s_{c+1} = s_c ⊙
//      exp(cum_last) + bx_c in chunk order (the formula of the sequential
//      form), each s_c kept as three bf16 pieces for phase 3;
//   3. ssd_tc_out, a block per (batch, chunk, 64-row tile, 2 heads):
//      y_inter from the pieces of s_c, y_intra with S = C·Bᵀ formed once
//      per 32 columns for both heads.
// Every product is mma.sync m16n8k16 (bf16 in, f32 sums): its 16-row
// fragments fit any L, P ≤ 64 and N ≤ 256 zero-padded to 16 in shared
// memory, and the decayed scores W are built in the very registers that
// hold S, whose layout is the next mma's A operand. wgmma would double the
// instruction's rate but wants warpgroup-wide 64-row tiles and swizzled
// operand layouts for every product here; it is later work (the two
// phases that multiply issue an HMMA every ~6-8 cycles per SM, PERF.md
// §7). bf16 x, B and C are exact operands; each f32 one (v = dt ⊙ x ⊙
// tail, the state, W) is split exactly into three bf16 pieces (hi, mid,
// lo), whose products with a bf16 operand are exact in f32, and summed lo
// first. No sum uses atomics: two calls give the same bits. Rows past L
// never enter a sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

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
  float* cum;                 // SIMT: (B, H, L) scratch; tensor cores: (B, NC, H, L) cum
  int B, NC, L, H, P, N;
  float* buf;                 // tensor cores: (B, NC, H, P, N) bx of each chunk
  void* pieces;               // tensor cores: (B, NC, H, 3, P, N) bf16, the entering states
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

// ---------------------------------------------------------------------------
// The tensor-core core: bf16 x, B and C, chunk-parallel in three launches.
namespace tcs {

constexpr int kRows = 64;           // rows of l in a phase-3 tile, and of m in every m tile
constexpr int kHeads = 2;           // heads of a phase-3 block: S = C·Bᵀ formed once for both
constexpr int kOutThreads = 128;    // phase 3: four warps, 16 rows of l each
constexpr int kStateThreads = 256;  // phase 1: eight warps, 16 p × 64 n of bx each
constexpr int kNBlock = 128;        // phase 1: columns of N per pass of the m tiles
constexpr int kNChunk = 64;         // phase 3: state columns staged at a time
constexpr int kMaxN = 256;
constexpr int kCarryThreads = 256;  // phase 2: a block of state entries
constexpr int kMaxCarry = 8;        // phase 2: chunks whose bx a thread loads up front

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

// phase 3's shared memory, in bf16 elements: C tile (kRows × ns), then a
// region that holds either the B tile (kRows × ns) and the heads' x tiles
// (kHeads × kRows × ps) or the three pieces of kNChunk columns of a head's
// entering state (3 × Ppad × qs); then three f32 arrays of kHeads × kRows
// (cum of the rows; cum of the m tile, and dt, or exp(cum_l0 − cum_m) · dt
// left of the diagonal). Row strides are odd multiples of 16 bytes, so the
// eight rows an ldmatrix reads fall in distinct banks.
constexpr int qs = kNChunk + 8;
struct Smem3 {
  int ns, ps, region;
};
__host__ __device__ inline Smem3 smem3(int N, int P) {
  Smem3 s;
  s.ns = pad16(N) + 8;
  s.ps = pad16(P) + 8;
  const int tiles = kRows * s.ns + kHeads * kRows * s.ps;
  const int pieces = 3 * pad16(P) * qs;
  s.region = tiles > pieces ? tiles : pieces;
  return s;
}
__host__ __device__ inline size_t smem3_bytes(int N, int P) {
  const Smem3 s = smem3(N, P);
  return 2 * (size_t)(kRows * s.ns + s.region) + 4 * (size_t)(3 * kHeads * kRows);
}
// phase 1's: the B tile (kRows × (kNBlock + 8)), the three pieces of v
// (3 × kRows × ps), then the scan's staging (kStateThreads f32)
__host__ __device__ inline size_t smem1_bytes(int P) {
  return 2 * (size_t)(kRows * (kNBlock + 8) + 3 * kRows * (pad16(P) + 8)) +
         4 * (size_t)kStateThreads;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a (16 × 16 bf16, row) · b (16 × 8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// rows [0, rows) × columns [0, width) of a bf16 plane (row stride ld
// elements) → dst (tile_rows × stride), zero-filled up to tile_rows ×
// cols. vec: 16-byte cp.async copies, all in flight at once (src and ld
// 16-byte aligned, width a multiple of 8), landed by cp_async_wait_all()
// before the block's next barrier; else 2-byte loads. The thread's (row,
// piece) steps without a division.
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* src, long long ld,
                                          int rows, int width, int cols, int vec, int tid,
                                          int nthreads, int tile_rows = kRows) {
  const int e = vec ? 8 : 1;        // elements a piece
  const int per = cols / e;         // pieces a row
  int r = tid / per, k = tid - r * per;
  const int dr = nthreads / per, dk = nthreads - dr * per;
  const bf16 zero = __float2bfloat16_rn(0.f);
  while (r < tile_rows) {
    const bool in = r < rows && k * e < width;
    bf16* d = dst + r * stride + k * e;
    if (vec) {
      if (in) cp_async16(d, src + r * ld + k * e);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else {
      *d = in ? src[r * ld + k] : zero;
    }
    r += dr;
    k += dk;
    if (k >= per) {
      k -= per;
      ++r;
    }
  }
}

// Phase 1, a block per (head, batch · chunk), P in NPP tiles of 16: cum
// (the chunk's running sum of logdec, one add after another) into a.cum,
// then bx = vᵀ · B with v = (x ⊙ dt) ⊙ exp(cum_last − cum) in three bf16
// pieces (lo, mid, hi) into a.buf, in the tensor cores' f32 sums (each
// 16-row step of m from zero, added by a round-to-nearest FADD, was no more
// accurate at the path's shapes and no faster, PERF.md §6); N in
// passes of kNBlock columns, zero-padded, so every warp's n tiles are
// whole.
template <int NPP>
__global__ void __launch_bounds__(kStateThreads, 2) ssd_tc_state(Args a, int vec_x, int vec_bc) {
  constexpr int Ppad = 16 * NPP, ps = Ppad + 8, per8 = Ppad / 8, nsb = kNBlock + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int L = a.L, H = a.H, P = a.P, N = a.N, Npad = pad16(N);
  bf16* Bs = reinterpret_cast<bf16*>(smem);    // kRows × nsb
  bf16* V = Bs + kRows * nsb;                  // 3 × kRows × ps: hi, mid, lo
  float* stage = reinterpret_cast<float*>(V + 3 * kRows * ps);
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / a.NC, c = bc % a.NC;
  const long long row0 = (long long)bc * L;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  float* cum = a.cum + ((long long)bc * H + h) * L;
  const bf16* x = static_cast<const bf16*>(a.x) + b * a.xsb + c * a.xsc + h * a.xsh;
  const bf16* bmat = static_cast<const bf16*>(a.bm) + b * a.bsb + c * a.bsc;

  // cum: the chunk's running sum of logdec, one add after another
  float carry = 0.f;
  for (int s0 = 0; s0 < L; s0 += kStateThreads) {
    if (s0 + t < L) stage[t] = a.logdec[(row0 + s0 + t) * H + h];
    __syncthreads();
    if (t == 0) {
      const int cnt = min(kStateThreads, L - s0);
      for (int k = 0; k < cnt; ++k) {
        carry += stage[k];
        cum[s0 + k] = carry;
      }
    }
    __syncthreads();
  }
  const float cum_last = cum[L - 1];

  float* dst = a.buf + ((long long)bc * H + h) * P * N;
  const int pt = warp & 3, nhalf = warp >> 2;  // the warp's 16 rows of p, 64 columns of n
  // ldmatrix addresses of the warp's lane: vᵀ's rows p (A, from V[m][p])
  // and B's columns n (from Bs[m][n]), both transposed on the way in
  const uint32_t va = smem_u32(V + ((lane & 7) + (lane >> 4) * 8) * ps + 16 * pt +
                               ((lane >> 3) & 1) * 8);
  const uint32_t ba = smem_u32(Bs + ((lane & 7) + ((lane >> 3) & 1) * 8) * nsb + 64 * nhalf +
                               (lane >> 4) * 8);
  for (int nb0 = 0; nb0 < Npad; nb0 += kNBlock) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int m0 = 0; m0 < L; m0 += kRows) {
      const int mrows = min(kRows, L - m0);
      __syncthreads();  // the previous tile's readers are done
      load_tile(Bs, nsb, bmat + (long long)m0 * a.bsl + nb0, a.bsl, mrows, min(N - nb0, kNBlock),
                kNBlock, vec_bc, t, kStateThreads);
      // v = (x ⊙ dt) ⊙ tail, tail = exp(cum_last − cum_m), in pieces, rows
      // m, 8 columns of p a thread (the B tile's copies in flight meanwhile)
      for (int i = t; i < kRows * per8; i += kStateThreads) {
        const int j = i / per8, p0 = (i % per8) * 8, m = m0 + j;
        float xv[8], dm = 0.f, tl = 0.f;
        const bf16* xr = x + (long long)m * a.xsl + p0;
        if (j < mrows) {
          dm = a.dt[(row0 + m) * H + h];
          tl = expf(cum_last - cum[m]);
        }
        if (vec_x && j < mrows && p0 < P) {
          const uint4 w = *reinterpret_cast<const uint4*>(xr);
          const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(w2[k]);
            xv[2 * k] = f.x;
            xv[2 * k + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            xv[k] = (j < mrows && p0 + k < P) ? __bfloat162float(xr[k]) : 0.f;
        }
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          split_pair(__fmul_rn(__fmul_rn(xv[2 * k], dm), tl),
                     __fmul_rn(__fmul_rn(xv[2 * k + 1], dm), tl), hi[k], mid[k], lo[k]);
        const int o = j * ps + p0;
        *reinterpret_cast<uint4*>(V + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(V + kRows * ps + o) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
        *reinterpret_cast<uint4*>(V + 2 * kRows * ps + o) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      cp_async_wait_all();
      __syncthreads();
      if (pt >= NPP) continue;  // P has fewer tiles than this warp's
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (16 * ks >= mrows) break;  // rows past L are zero: no work
        uint32_t av[3][4];            // vᵀ's fragments: hi, mid, lo
#pragma unroll
        for (int k = 0; k < 3; ++k) ldsm4t(va + 2 * (k * kRows + 16 * ks) * ps, av[k]);
        uint32_t bf[4][4];            // B's fragments, 16 columns of n each
#pragma unroll
        for (int np = 0; np < 4; ++np) ldsm4t(ba + 2 * (16 * ks * nsb + 16 * np), bf[np]);
        // piece by piece (lo, mid, hi), each over the warp's eight n tiles:
        // eight independent sums between two steps of one
#pragma unroll
        for (int k = 2; k >= 0; --k)
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            mma(acc[2 * np], av[k], bf[np][0], bf[np][1]);
            mma(acc[2 * np + 1], av[k], bf[np][2], bf[np][3]);
          }
      }
    }
    if (pt >= NPP) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb0 + 64 * nhalf + 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * pt + g + 8 * half;
        if (p >= P) continue;
        float* d = dst + (long long)p * N + n;
        if (n + 1 < N && !(N & 1)) {  // an aligned pair: n even, N even
          *reinterpret_cast<float2*>(d) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        } else {
          if (n < N) d[0] = acc[j][2 * half];
          if (n + 1 < N) d[1] = acc[j][2 * half + 1];
        }
      }
    }
  }
}

// Phase 2, a thread per V consecutive state entries of each (batch, head):
// the carry over the chunks in order, s_{c+1} = s_c ⊙ exp(cum_last) + bx_c
// (a multiply, then an add, each rounded: never fused), writing the state
// that enters each chunk to a.pieces as its three bf16 pieces (hi, mid,
// lo planes), and the last one to a.state.
template <int V>
__global__ void __launch_bounds__(kCarryThreads) ssd_tc_carry(Args a) {
  using FV = typename std::conditional<V == 2, float2, float>::type;
  const long long PN = (long long)a.P * a.N;
  const long long e = ((long long)blockIdx.x * kCarryThreads + threadIdx.x) * V;
  if (e >= PN) return;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const auto ld = [&](const float* p) {
    float v[V];
    if constexpr (V == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      v[0] = f.x;
      v[1] = f.y;
    } else {
      v[0] = *p;
    }
    return *reinterpret_cast<FV*>(v);
  };
  float s[V];
  const FV s0 = a.init ? ld(a.init + bh * PN + e) : FV{};
  *reinterpret_cast<FV*>(s) = s0;
  const auto bx_of = [&](int c) {
    return ld(a.buf + (((long long)b * a.NC + c) * a.H + h) * PN + e);
  };
  const auto step = [&](int c, FV bxv) {
    const float* bx = reinterpret_cast<const float*>(&bxv);
    const long long bch = ((long long)b * a.NC + c) * a.H + h;
    bf16* pc = static_cast<bf16*>(a.pieces) + bch * 3 * PN + e;
    bf16 hi[V], mid[V], lo[V];
    const float dec = expf(a.cum[bch * a.L + a.L - 1]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hi[k] = __float2bfloat16_rn(s[k]);
      const float r = __fsub_rn(s[k], __bfloat162float(hi[k]));
      mid[k] = __float2bfloat16_rn(r);
      lo[k] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid[k])));
      s[k] = __fadd_rn(__fmul_rn(s[k], dec), bx[k]);
    }
    if (c == 0 && !a.init) return;  // a zero state: phase 3 skips its product
    if constexpr (V == 2) {
      *reinterpret_cast<__nv_bfloat162*>(pc) = __halves2bfloat162(hi[0], hi[1]);
      *reinterpret_cast<__nv_bfloat162*>(pc + PN) = __halves2bfloat162(mid[0], mid[1]);
      *reinterpret_cast<__nv_bfloat162*>(pc + 2 * PN) = __halves2bfloat162(lo[0], lo[1]);
    } else {
      pc[0] = hi[0];
      pc[PN] = mid[0];
      pc[2 * PN] = lo[0];
    }
  };
  FV bx[kMaxCarry];
#pragma unroll
  for (int c = 0; c < kMaxCarry; ++c) bx[c] = c < a.NC ? bx_of(c) : FV{};  // all in flight
#pragma unroll
  for (int c = 0; c < kMaxCarry; ++c)
    if (c < a.NC) step(c, bx[c]);
  for (int c = kMaxCarry; c < a.NC; ++c) step(c, bx_of(c));
  *reinterpret_cast<FV*>(a.state + bh * PN + e) = *reinterpret_cast<FV*>(s);
}

// Phase 3, a block per (row tile, head group, batch · chunk), the longest
// row tiles first, P in NPP tiles of 16: y = (C_l · s_cᵀ) ⊙ exp(cum_l) +
// Σ_{m ≤ l} W_lm x_m with W = (S ⊙ exp(cum_l − cum_m)) ⊙ dt_m, S = C·Bᵀ
// formed once per 32 columns of m for both heads of the block, the state
// and W in three bf16 pieces (lo, mid, hi). On the tiles left of the
// diagonal (every m below the tile's first row l0) the decay factors,
// exp(cum_l − cum_l0) · exp(cum_l0 − cum_m), both ≤ 1: W's columns take
// the second, and the rows the first once those tiles are summed, so that
// an exponential is per row and per column, not per entry. The diagonal
// tile, last, takes exp(cum_l − cum_m) per entry, its argument masked to
// −∞ above the diagonal (and at rows past L) before the exponential. A
// group with one head left (H odd) computes that head twice and stores it
// once, so that no mma waits behind a branch on the head.
template <int NPP>
__global__ void __launch_bounds__(kOutThreads, 4)
ssd_tc_out(Args a, int vec_x, int vec_bc, int vec_pc) {
  constexpr int Ppad = 16 * NPP, ps = Ppad + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const int L = a.L, H = a.H, P = a.P, N = a.N, Npad = pad16(N);
  const Smem3 s = smem3(N, P);
  const int ns = s.ns;
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // kRows × ns
  bf16* Bs = Cs + kRows * ns;                // kRows × ns
  bf16* Xs = Bs + kRows * ns;                // kHeads × kRows × ps
  bf16* SP = Bs;                             // 3 × Ppad × qs over Bs and Xs: hi, mid, lo
  float* cl = reinterpret_cast<float*>(Cs + kRows * ns + s.region);
  float* cmv = cl + kHeads * kRows;
  float* dtm = cmv + kHeads * kRows;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int nrt = (L + kRows - 1) / kRows;
  const int l0 = (nrt - 1 - (int)blockIdx.x) * kRows;
  const int h0 = blockIdx.y * kHeads;
  int hs[kHeads];                            // the heads computed (the last one repeated)
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) hs[hh] = min(h0 + hh, H - 1);
  const int bc = blockIdx.z, b = bc / a.NC, c = bc % a.NC;
  const long long row0 = (long long)bc * L;
  const bf16* x = static_cast<const bf16*>(a.x) + b * a.xsb + c * a.xsc;
  const bf16* bmat = static_cast<const bf16*>(a.bm) + b * a.bsb + c * a.bsc;
  const bf16* cmat = static_cast<const bf16*>(a.cm) + b * a.csb + c * a.csc;
  const float* cum = a.cum + (long long)bc * H * L;
  const int rows = min(kRows, L - l0);
  const int lw0 = l0 + 16 * warp;            // the warp's first row
  const int lw1 = min(lw0 + 15, L - 1);      // and its last (< lw0: none)

  load_tile(Cs, ns, cmat + (long long)l0 * a.csl, a.csl, rows, N, Npad, vec_bc, t, kOutThreads);
  for (int i = t; i < kHeads * kRows; i += kOutThreads) {
    const int hh = i / kRows, r = i % kRows;  // rows past L: exp(cum_l) = 0 and W = 0
    cl[i] = r < rows ? cum[(long long)min(h0 + hh, H - 1) * L + l0 + r] : -INFINITY;
  }
  // ldmatrix addresses of the lane: C's rows (A), and B's rows m, the
  // state pieces' rows p (B, K = n contiguous), the x tiles' rows m (B,
  // transposed)
  const int ns2 = 2 * ns;
  const uint32_t ca = smem_u32(Cs + (16 * warp + (lane & 15)) * ns + (lane >> 4) * 8);
  const uint32_t kb_lane = ((lane & 7) + (lane >> 4) * 8) * ns2 + ((lane >> 3) & 1) * 16;
  const uint32_t ba = smem_u32(Bs) + kb_lane;
  const uint32_t spa = smem_u32(SP) + ((lane & 7) + (lane >> 4) * 8) * 2 * qs +
                       ((lane >> 3) & 1) * 16;
  const uint32_t xa = smem_u32(Xs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * 2 * ps +
                      (lane >> 4) * 16;

  float acc[kHeads][2 * NPP][4];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
    for (int j = 0; j < 2 * NPP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.f;

  // y_inter = (C_l · s_cᵀ) ⊙ exp(cum_l); the state entering the first
  // chunk is exactly 0 when no initial state is given: nothing to add
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (c == 0 && !a.init) break;
    const bf16* pc = static_cast<const bf16*>(a.pieces) + ((long long)bc * H + hs[hh]) * 3 * P * N;
    for (int n0 = 0; n0 < Npad; n0 += kNChunk) {
      const int nw = min(kNChunk, Npad - n0);
      __syncthreads();  // Cs and cl staged; the previous chunk's readers done
#pragma unroll
      for (int k = 0; k < 3; ++k)
        load_tile(SP + k * Ppad * qs, qs, pc + (long long)k * P * N + n0, N, P, N - n0, nw,
                  vec_pc, t, kOutThreads, Ppad);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kNChunk / 16; ++ks) {
        if (16 * ks >= nw) break;
        uint32_t af[4];
        ldsm4(ca + 2 * (n0 + 16 * ks), af);
#pragma unroll
        for (int k = 2; k >= 0; --k) {  // lo, mid, hi, each over all of P's tiles
          uint32_t bf[NPP][4];
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp)
            ldsm4(spa + 2 * ((k * Ppad + 16 * pp) * qs + 16 * ks), bf[pp]);
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp) {
            mma(acc[hh][2 * pp], af, bf[pp][0], bf[pp][1]);
            mma(acc[hh][2 * pp + 1], af, bf[pp][2], bf[pp][3]);
          }
        }
      }
    }
  }
  __syncthreads();  // cl staged, also where y_inter had nothing to add
  // exp(cum_l) = exp(cum_l0) · exp(cum_l − cum_l0), both factors ≤ 1 (cum
  // falls along l): y_inter takes the first now, and the off-diagonal
  // tiles' sum joins it before the rows take the second
  float cl_w[kHeads][2];                     // cum of the lane's two rows
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    cl_w[hh][0] = cl[hh * kRows + 16 * warp + g];
    cl_w[hh][1] = cl[hh * kRows + 16 * warp + g + 8];
    const float e = expf(cl[hh * kRows]);
#pragma unroll
    for (int j = 0; j < 2 * NPP; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[hh][j][k] *= e;
  }

  // y_intra, one m tile of kRows at a time, up to the tile's last row
  for (int m0 = 0; m0 < l0 + rows; m0 += kRows) {
    const int mrows = min(kRows, L - m0);
    const bool diag = m0 + kRows > l0;       // the tile holds columns past some row
    __syncthreads();  // the previous tile's (or the state pieces') readers are done
    load_tile(Bs, ns, bmat + (long long)m0 * a.bsl, a.bsl, mrows, N, Npad, vec_bc, t,
              kOutThreads);
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
      load_tile(Xs + hh * kRows * ps, ps, x + (long long)m0 * a.xsl + hs[hh] * a.xsh, a.xsl,
                mrows, P, Ppad, vec_x, t, kOutThreads);
    // the diagonal tile: cum_m and dt_m; any other: exp(cum_l0 − cum_m) · dt_m
    for (int i = t; i < kHeads * kRows; i += kOutThreads) {
      const int hh = i / kRows, j = i % kRows, hd = min(h0 + hh, H - 1);
      const bool ok = j < mrows;
      const float cm = ok ? cum[(long long)hd * L + m0 + j] : 0.f;
      const float dt = ok ? a.dt[(row0 + m0 + j) * H + hd] : 0.f;
      cmv[i] = cm;
      dtm[i] = diag ? dt : expf(cl[hh * kRows] - cm) * dt;
    }
    cp_async_wait_all();
    __syncthreads();
    if (diag) {  // the last tile: the rows take exp(cum_l − cum_l0)
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        const float e0 = expf(cl_w[hh][0] - cl[hh * kRows]);
        const float e1 = expf(cl_w[hh][1] - cl[hh * kRows]);
#pragma unroll
        for (int j = 0; j < 2 * NPP; ++j) {
          acc[hh][j][0] *= e0;
          acc[hh][j][1] *= e0;
          acc[hh][j][2] *= e1;
          acc[hh][j][3] *= e1;
        }
      }
    }
#pragma unroll
    for (int sub = 0; sub < kRows / 32; ++sub) {
      const int ms = m0 + 32 * sub;
      if (ms > lw1) break;  // no row of this warp reaches these columns
      float S[4][4];        // S over 32 columns of m
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
      for (int k0 = 0; k0 < Npad; k0 += 16) {
        uint32_t af[4], bf[2][4];
        ldsm4(ca + 2 * k0, af);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) ldsm4(ba + (32 * sub + 16 * jp) * ns2 + 2 * k0, bf[jp]);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma(S[2 * jp], af, bf[jp][0], bf[jp][1]);
          mma(S[2 * jp + 1], af, bf[jp][2], bf[jp][3]);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ms + 16 * ks > lw1) break;
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * ks + jj;
            const int jm = 32 * sub + 8 * j + 2 * q;  // column within the m tile
            const float2 cm2 = *reinterpret_cast<const float2*>(cmv + hh * kRows + jm);
            const float2 dt2 = *reinterpret_cast<const float2*>(dtm + hh * kRows + jm);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float w0 = S[j][2 * half] * dt2.x, w1 = S[j][2 * half + 1] * dt2.y;
              if (diag) {  // the decay's argument masked to −∞ before the exponential
                const int l = lw0 + g + 8 * half, m = m0 + jm;
                const float cl_l = cl_w[hh][half];
                const float d0 = (m <= l && m < L) ? cl_l - cm2.x : -INFINITY;
                const float d1 = (m + 1 <= l && m + 1 < L) ? cl_l - cm2.y : -INFINITY;
                w0 = S[j][2 * half] * expf(d0) * dt2.x;
                w1 = S[j][2 * half + 1] * expf(d1) * dt2.y;
              }
              split_pair(w0, w1, ahi[2 * jj + half], amid[2 * jj + half], alo[2 * jj + half]);
            }
          }
          uint32_t bf[NPP][4];
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp)
            ldsm4t(xa + 2 * (hh * kRows * ps + (32 * sub + 16 * ks) * ps + 16 * pp), bf[pp]);
          // piece by piece (lo, mid, hi), each over all of P's tiles
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp) {
            mma(acc[hh][2 * pp], alo, bf[pp][0], bf[pp][1]);
            mma(acc[hh][2 * pp + 1], alo, bf[pp][2], bf[pp][3]);
          }
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp) {
            mma(acc[hh][2 * pp], amid, bf[pp][0], bf[pp][1]);
            mma(acc[hh][2 * pp + 1], amid, bf[pp][2], bf[pp][3]);
          }
#pragma unroll
          for (int pp = 0; pp < NPP; ++pp) {
            mma(acc[hh][2 * pp], ahi, bf[pp][0], bf[pp][1]);
            mma(acc[hh][2 * pp + 1], ahi, bf[pp][2], bf[pp][3]);
          }
        }
      }
    }
  }

  bf16* y = static_cast<bf16*>(a.y);
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (h0 + hh >= H) break;
#pragma unroll
    for (int j = 0; j < 2 * NPP; ++j) {
      const int p = 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = lw0 + g + 8 * half;
        if (l >= L) continue;
        bf16* yr = y + ((row0 + l) * H + h0 + hh) * P;
        const float v0 = acc[hh][j][2 * half], v1 = acc[hh][j][2 * half + 1];
        if (p + 1 < P && !(P & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (p < P) yr[p] = __float2bfloat16_rn(v0);
          if (p + 1 < P) yr[p + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// the grid of the output phase, as kernels/ssd.py · plan lays it out
struct Grid {
  int row_tiles, head_groups;
};
inline Grid grid_of(int L, int H) {
  return {(L + kRows - 1) / kRows, (H + kHeads - 1) / kHeads};
}

template <int NPP>
cudaError_t launch_p(const Args& a, int vec_x, int vec_bc, cudaStream_t st) {
  const size_t s1 = smem1_bytes(a.P), s3 = smem3_bytes(a.N, a.P);
  // opted in once per device, at the most any P of this NPP and N ≤ kMaxN use
  static unsigned long long opted_in1 = 0, opted_in3 = 0;
  cudaError_t err = opt_in_smem(ssd_tc_state<NPP>, static_cast<int>(smem1_bytes(16 * NPP)),
                                opted_in1);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(ssd_tc_out<NPP>, static_cast<int>(smem3_bytes(kMaxN, 16 * NPP)), opted_in3);
  if (err != cudaSuccess) return err;
  const Grid gr = grid_of(a.L, a.H);
  ssd_tc_state<NPP><<<dim3(a.H, a.B * a.NC), kStateThreads, s1, st>>>(a, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long pn = (long long)a.P * a.N;
  if (pn % 2 == 0)
    ssd_tc_carry<2><<<dim3((unsigned)((pn / 2 + kCarryThreads - 1) / kCarryThreads), a.B * a.H),
                      kCarryThreads, 0, st>>>(a);
  else
    ssd_tc_carry<1><<<dim3((unsigned)((pn + kCarryThreads - 1) / kCarryThreads), a.B * a.H),
                      kCarryThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_tc_out<NPP><<<dim3(gr.row_tiles, gr.head_groups, a.B * a.NC), kOutThreads, s3, st>>>(
      a, vec_x, vec_bc, a.N % 8 == 0);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int vec_x, int vec_bc, cudaStream_t st) {
  switch (pad16(a.P) / 16) {
    case 1: return launch_p<1>(a, vec_x, vec_bc, st);
    case 2: return launch_p<2>(a, vec_x, vec_bc, st);
    case 3: return launch_p<3>(a, vec_x, vec_bc, st);
    case 4: return launch_p<4>(a, vec_x, vec_bc, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tcs

}  // namespace

// x (B, NC, L, H, P) bf16 (x_bf16 = 1) or f32 at element strides
// (xsb, xsc, xsl, xsh, 1); dt, logdec (B, NC, L, H) f32 contiguous; b and c
// (B, NC, L, N) in x's dtype at strides (·sb, ·sc, ·sl, 1); init (B, H, P,
// N) f32 or null; y (B, NC, L, H, P) in x's dtype and state (B, H, P, N) f32,
// both contiguous. core 0 (SIMT; any dtype, P ≤ 64, a state that fits in
// shared memory): cum a (B, H, L) f32 scratch, buf and pieces unused.
// core 1 (tensor cores; bf16 only, P ≤ 64, N ≤ 256): cum (B, NC, H, L) and
// buf (B, NC, H, P, N) f32 and pieces (B, NC, H, 3, P, N) bf16 scratch,
// and row_tiles, head_groups the grid kernels/ssd.py · plan laid out
// (checked against this file's tiles). Returns the cudaError_t of the
// launches (0 = success).
extern "C" int ssd_chunk_scan_launch(const void* x, int x_bf16, long long xsb, long long xsc,
                                     long long xsl, long long xsh, const float* dt,
                                     const float* logdec, const void* bm, long long bsb,
                                     long long bsc, long long bsl, const void* cm,
                                     long long csb, long long csc, long long csl,
                                     const float* init, void* y, float* state, float* cum,
                                     float* buf, void* pieces, int B, int NC, int L, int H,
                                     int P, int N,
                                     int core, int row_tiles, int head_groups, void* stream) {
  if (P > kMaxP || P < 1 || N < 1 || L < 1) return cudaErrorInvalidValue;
  const Args a{x, xsb, xsc, xsl, xsh, dt, logdec, bm, bsb, bsc, bsl, cm, csb, csc, csl,
               init, y, state, cum, B, NC, L, H, P, N, buf, pieces};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (core == 1) {
    const tcs::Grid gr = tcs::grid_of(L, H);
    if (!x_bf16 || N > tcs::kMaxN || gr.row_tiles != row_tiles || gr.head_groups != head_groups)
      return cudaErrorInvalidValue;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
    const uintptr_t ba = reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm);
    const int vec_x = ((xa | 2 * (xsb | xsc | xsl | xsh)) % 16 == 0) && P % 8 == 0;
    const int vec_bc = ((ba | 2 * (bsb | bsc | bsl | csb | csc | csl)) % 16 == 0) && N % 8 == 0;
    return tcs::launch(a, vec_x, vec_bc, st);
  }
  if (core != 0 || row_tiles != 1 || head_groups != H) return cudaErrorInvalidValue;
  const size_t ns = N + 1;
  const size_t smem = 4 * (P * ns + 2 * kTile * ns + kTile * P + kTile * (kTile + 1) +
                           2 * kTile + kThreads);
  return x_bf16 ? launch<__nv_bfloat16>(a, smem, st) : launch<float>(a, smem, st);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
