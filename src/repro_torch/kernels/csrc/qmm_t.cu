// qmm_t — the transposed dequantize-matmul: dx = g · (codes ⊙ scale)ᵀ.
//
// Replaces: src/repro/kernels/qmm.py · qmm_t (_qmm_t_kernel), the Pallas
// TPU kernel behind the code-domain backward of every QTensor / ShipWeight
// matmul (quant_dense's VJP: dx streams codes instead of re-decoding a
// bf16 weight), and behind the tied unembed of a quantized table.
//
// Computes dx[M, K] = Σ_n g[M, n] · codes[K, n] · scale[n] in f32. g is f32
// or bf16; codes are int8 (K, N) or packed int4 (K, N/2) uint8 (offset-
// binary, code + 8, low nibble = even column). The scale lies on the
// contraction axis, so it goes with g: both cores multiply the codes by
// v = g · scale, rounded once to f32 (the f32-dequant oracle rounds
// code · scale once instead: the two agree within f32 rounding). M, K and
// N may be ragged: every load and store is masked, nothing is padded.
//
// Two cores, chosen by kernels/qmm_t.py · plan from M alone and never here:
//
// * M above plan's threshold (training: M = B·S = 2048) — the tensor-core
//   core (kCoreTc). 2·M·K·N operations against g and the codes once each
//   lie far above the card's ~295 operations per byte: the bound is the
//   operations. The codes are integers of at most 8 bits, exact in bf16;
//   v is not, but its 24-bit significand splits exactly into three bf16
//   pieces, hi = bf16(v), mid = bf16(v − hi), lo = bf16(v − hi − mid), each
//   subtraction exact in f32. Each piece × code is an exact product that
//   the tensor cores sum in f32, so three bf16 wgmma passes compute the f32
//   product up to summation order, at a third of the bf16 rate. Exactness
//   holds for |v| ≥ 2^−110; below it lo's last bits fall under bf16's
//   smallest subnormal (2^−133), and the tensor cores may flush subnormal
//   pieces: at most ~2^−126 per term, far inside the rel 1e-5 contract. A
//   finite |v| above bf16's largest finite (~3.39e38) and a non-finite g
//   split into inf/NaN pieces: such a row of dx is non-finite, as the
//   oracle's is. A split kernel (qmm_t_split) writes the pieces once as
//   three bf16 (M, N) planes (v computed with __fmul_rn: no FMA
//   contraction may fuse it into the subtraction); splitting g's tile
//   inside the product instead, once per 256 dx columns, was 4-12 % slower
//   at gate/up and down and 5 % faster at k/v (PERF.md §6). Tile: 128 dx
//   rows × 256 dx columns (code rows) per block, contraction steps of 64,
//   two warpgroups of 64 rows each (a 64-row tile re-read the pieces and
//   the codes from L2 for every 64 × 256 outputs, and those loads set its
//   pace); a tile of 64 rows or fewer (M 9-64) gives each warpgroup one
//   128-column half of them instead (B11's split-N tile). A 2-deep cp.async ring lands the three piece tiles
//   (128B-swizzled, K-major) and the raw code tile; at step kt each block
//   converts code tile kt into bf16, K-major and swizzled as wgmma reads an
//   untransposed B (the code plane's rows have the contraction contiguous),
//   into one of two buffers, while step kt − 1's second half runs. Each
//   warpgroup multiplies its 64 rows by one 128-column half at a time: 12
//   asynchronous wgmma m64n128k16 steps — lo's four first, hi's last, the
//   first from zero — into t, then t is added to that half's f32
//   accumulators with round-to-nearest FADDs: the tensor cores' own
//   accumulation rounds toward zero, so it only ever sums one step
//   (3 × 64 products). The contraction is split (gridDim.z) only where
//   the (M, K) tiles alone cannot fill the 132 SMs; qmm_core.cuh's
//   splitk_reduce sums the f32 partials in split order, so results are
//   deterministic. One block per SM (~193 KB of dynamic shared memory,
//   opted in per device).
//
// * M up to the threshold (the tied unembed's readouts: M 4 at decode, 1
//   per prefill, K = 256000 vocab rows) — the streaming core (kCoreStream).
//   2·M operations per code byte: the bound is the code bytes over HBM
//   bandwidth. Each block folds v = g · scale for up to 8 rows of g into
//   shared memory in f32, 2048 columns at a time (padded so that a warp's
//   16-byte reads hit distinct banks). Each warp takes 4 code rows at a
//   time; each lane reads 16 codes of every 512-column chunk of each row
//   with one 16-byte (int8) or 8-byte (int4) load, all of a batch's loads
//   issued before the FMAs (8 KB per warp in flight at int8); bytes turn into
//   floats with qmm_core.cuh's byte permute + FADD (no I2F), and each lane
//   sums its columns in f32. The 32 lanes' partial dots are added by an
//   xor-shuffle butterfly, the same order in every lane; a wider N adds
//   each 2048-column slab to dx in order. M above 8 runs 8 rows of g per
//   block row (grid.y), reading the codes once per 8 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_core.cuh"

namespace {

// the ids of kernels/qmm_t.py's CORES: the streaming core, and kCoreTc
// (qmm_core.cuh's id of the tensor-core core, 1)
constexpr int kCoreStream = 0;

// ------------------------------------------------------- the streaming core

namespace streaming {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int U = 4;              // code rows per warp batch
constexpr int C = 16;             // codes per lane per load
constexpr int CHUNK = 32 * C;     // columns per warp load (512)
constexpr int NS = 2048;          // columns of v staged in shared memory at a time
constexpr int CH = NS / CHUNK;    // chunks per slab
constexpr int PAD = 4;            // floats after every 16 columns' values
constexpr int MAX_MB = 8;         // rows of g per block row
constexpr int BLOCKS = 2 * 132;   // two blocks per SM

__host__ __device__ constexpr int group_floats(int mb) { return 16 * mb + PAD; }
__host__ __device__ constexpr int smem_bytes(int mb) { return (NS / 16) * group_floats(mb) * 4; }

// the E·MB floats of v for E consecutive columns of a lane's 16 (at vp),
// in 16-byte reads: v[e·MB + m] is row m of column e
template <int E, int MB>
__device__ __forceinline__ void v_cols(const float* vp, float* v) {
#pragma unroll
  for (int j = 0; j < E * MB; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(vp + j);
    v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
  }
}

template <typename GT, bool PACKED, int MB>
__global__ void __launch_bounds__(kThreads, 2)
qmm_t_stream(const GT* __restrict__ g, const uint8_t* __restrict__ codes,
             const float* __restrict__ scale, float* __restrict__ dx, int M, int K, int N,
             int vec_ok) {
  using T = typename simt::Raw<PACKED>::T;
  constexpr int WORDS = sizeof(T) / 4;
  constexpr int PER_WORD = PACKED ? 8 : 4;
  constexpr int GF = group_floats(MB);
  extern __shared__ __align__(16) float vs[];   // vs[(j / 16)·GF + (j mod 16)·MB + m] = v[m0 + m][s0 + j]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * MB;
  const int row_bytes = PACKED ? N / 2 : N;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;

  for (int s0 = 0; s0 < N; s0 += NS) {
    __syncthreads();
    for (int i = threadIdx.x; i < NS * MB; i += kThreads) {
      const int j = i / MB, m = i % MB, n = s0 + j;
      vs[(j >> 4) * GF + (j & 15) * MB + m] =
          (n < N && m0 + m < M) ? __fmul_rn(to_f32(g[(size_t)(m0 + m) * N + n]), scale[n])
                                : 0.f;
    }
    __syncthreads();
    const int nch = min(CH, (N - s0 + CHUNK - 1) / CHUNK);
    for (int k0 = gw * U; k0 < K; k0 += nw * U) {
      T raw[U][CH];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int n0 = s0 + c * CHUNK + lane * C;
          raw[u][c] = T{};
          if (k0 + u < K && c < nch && n0 < N) {
            const int byte0 = PACKED ? n0 / 2 : n0;
            raw[u][c] = simt::load_raw<PACKED>(codes + (size_t)(k0 + u) * row_bytes + byte0,
                                               vec_ok && n0 + C <= N,
                                               min((int)sizeof(T), row_bytes - byte0));
          }
        }
      float acc[U][MB];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[u][m] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c >= nch) break;
        const float* vp = vs + (c * 32 + lane) * GF;
#pragma unroll
        for (int q = 0; q < WORDS; ++q) {
          float v[PER_WORD * MB];
          v_cols<PER_WORD, MB>(vp + q * PER_WORD * MB, v);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            uint32_t words[WORDS];
            simt::words_of(raw[u][c], words);
            float w[PER_WORD];
            decode_word<PACKED>(words[q], w);
#pragma unroll
            for (int e = 0; e < PER_WORD; ++e)
#pragma unroll
              for (int m = 0; m < MB; ++m) acc[u][m] = fmaf(w[e], v[e * MB + m], acc[u][m]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          float s = acc[u][m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == (u * MB + m) % 32 && k0 + u < K && m0 + m < M) {
            float* o = dx + (size_t)(m0 + m) * K + k0 + u;
            *o = s0 == 0 ? s : *o + s;
          }
        }
    }
  }
}

}  // namespace streaming

// -------------------------------------------------- the tensor-core core

namespace tct {

// wgmma_tile.cuh's tile: two warpgroups of 64 rows of the tile each, BM
// dx rows × BN dx columns, contraction steps of BK (kernels/qmm_t.py ·
// TC_TILE)
using tc::BK;
using tc::BM;
using tc::BN;
using tc::kThreads;
using tc::ROW;
constexpr int STAGES = 2;                // cp.async ring of piece and code tiles
constexpr int AS = BM * ROW;             // one bf16 piece tile, K-major, swizzled (16 KB)
constexpr int BS = BN * ROW;             // one converted code tile (32 KB)

template <bool PACKED>
struct Smem {
  static constexpr int RAWC = BN * (PACKED ? BK / 2 : BK);   // raw code tile
  static constexpr int STAGE = 3 * AS + RAWC;                // pieces hi, mid, lo + codes
  static constexpr int BYTES = 1024 + STAGES * STAGE + 2 * BS;  // + alignment
};

// rows [r0, r0 + ROWS) × bytes [b0, b0 + RB) of a row-major array (ld bytes
// a row) → dst, RB bytes a row (128B-swizzled when SWZ), in W-byte pieces
// (cp.async for W ≥ 4, plain copies below); rows ≥ R and bytes ≥ b_end
// read as 0. It also loads the piece tiles, which tc::load_x could: that
// build ran the M 2048 rows 3-9 % slower (PERF.md §6)
template <int ROWS, int RB, int W, bool SWZ>
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, long long ld,
                                          int R, int r0, long long b0, long long b_end) {
  constexpr int PER_ROW = RB / W;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const long long b = b0 + c * W;
    const int valid = (r0 + r < R) ? (int)min(max(b_end - b, 0LL), (long long)W) : 0;
    uint8_t* d = dst + (SWZ ? tc::swz(r, c * W) : r * RB + c * W);
    const uint8_t* s = src + (long long)(r0 + r) * ld + b;
    if constexpr (W >= 4) {
      if (valid) tc::cp_async<W>(tc::smem_u32(d), s, valid);
      else tc::zero_piece<W>(d);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) d[j] = j < valid ? s[j] : 0;
    }
  }
}

template <int ROWS, int RB, bool SWZ>
__device__ __forceinline__ void load_tile_w(int w, uint8_t* dst, const uint8_t* src,
                                            long long ld, int R, int r0, long long b0,
                                            long long b_end) {
  switch (w) {
    case 16: load_tile<ROWS, RB, 16, SWZ>(dst, src, ld, R, r0, b0, b_end); break;
    case 8: load_tile<ROWS, RB, 8, SWZ>(dst, src, ld, R, r0, b0, b_end); break;
    case 4: load_tile<ROWS, RB, 4, SWZ>(dst, src, ld, R, r0, b0, b_end); break;
    case 2: load_tile<ROWS, RB, 2, SWZ>(dst, src, ld, R, r0, b0, b_end); break;
    default: load_tile<ROWS, RB, 1, SWZ>(dst, src, ld, R, r0, b0, b_end); break;
  }
}

// step n0's tiles: the three pieces' [m0 .. m0+BM, n0 .. n0+BK] (swizzled,
// AS apart) and the raw codes[k0 .. k0+BN, n0 .. n0+BK]; PW, CW the piece
// widths when known at compile time (the aligned instance), 0 to switch on
// pw, cw at run time
template <bool PACKED, int PW, int CW>
__device__ __forceinline__ void load_stage(uint8_t* stage, const __nv_bfloat16* pieces,
                                           const uint8_t* codes, int M, int K, int N, int m0,
                                           int k0, int n0, int n_end, int pw, int cw) {
  constexpr int CB = PACKED ? BK / 2 : BK;
  const uint8_t* pb = reinterpret_cast<const uint8_t*>(pieces);
  const long long plane = 2LL * M * N, row_bytes = PACKED ? N / 2 : N;
  const long long cb0 = PACKED ? n0 / 2 : n0, cb_end = PACKED ? (n_end + 1) / 2 : n_end;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if constexpr (PW != 0)
      load_tile<BM, BK * 2, PW, true>(stage + p * AS, pb + p * plane, 2LL * N, M, m0, 2LL * n0,
                                      2LL * n_end);
    else
      load_tile_w<BM, BK * 2, true>(pw, stage + p * AS, pb + p * plane, 2LL * N, M, m0,
                                    2LL * n0, 2LL * n_end);
  }
  if constexpr (CW != 0)
    load_tile<BN, CB, CW, false>(stage + 3 * AS, codes, row_bytes, K, k0, cb0, cb_end);
  else
    load_tile_w<BN, CB, false>(cw, stage + 3 * AS, codes, row_bytes, K, k0, cb0, cb_end);
}

__device__ __forceinline__ void st16(uint8_t* p, const uint32_t* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// a landed raw code tile (BN rows of BK codes) → bf16, K-major and
// swizzled: row r (a dx column) holds its 64 codes as one 128-byte row,
// as wgmma reads an untransposed B. Item (r, c): 16 codes of row r, two
// 16-byte stores
template <bool PACKED>
__device__ __forceinline__ void convert_codes(const uint8_t* rc, uint8_t* bs) {
  for (int i = threadIdx.x; i < BN * (BK / 16); i += kThreads) {
    const int r = i >> 2, c = i & 3;
    uint32_t o[8];
    if constexpr (PACKED) {
      const uint2 v = *reinterpret_cast<const uint2*>(rc + r * (BK / 2) + c * 8);
      const uint32_t words[2] = {v.x, v.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float w[8];
        decode_word<true>(words[q], w);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[4 * q + j] = pack_bf16x2(w[2 * j], w[2 * j + 1]);
      }
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(rc + r * BK + c * 16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float w[4];
        decode_word<false>(words[q], w);
        o[2 * q] = pack_bf16x2(w[0], w[1]);
        o[2 * q + 1] = pack_bf16x2(w[2], w[3]);
      }
    }
    st16(bs + tc::swz(r, c * 32), o);
    st16(bs + tc::swz(r, c * 32 + 16), o + 4);
  }
}

// t = one contraction step of the tile's rows 64·r .. 64·r + 63 × the
// 128-column half h, from zero: the lo piece's four k16 steps first, hi's
// last (a: the piece tiles hi, mid, lo at AS apart; b: the converted code
// tile)
__device__ __forceinline__ void mma_half(float* t, uint32_t a, uint32_t b, int r, int h) {
  const uint32_t a0 = a + r * 64 * ROW, b0 = b + h * 128 * ROW;
  tc::wgmma_fence();
#pragma unroll
  for (int p = 2; p >= 0; --p)
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      tc::wgmma_step<0>(t, tc::desc(a0 + p * AS + ks * 32, 16, 1024),
                        tc::desc(b0 + ks * 32, 16, 1024), p != 2 || ks != 0);
  tc::wgmma_commit();
}

// wait for t and add it to the 64 accumulators with round-to-nearest FADDs
__device__ __forceinline__ void add_product(float* acc, float* t) {
  tc::wgmma_wait<0>();
  tc::pin(t);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += t[i];
}

// One 128 × 256 tile of dx over the block's contraction range (the design
// notes are at the top of this file): dx itself with one slice, else this
// slice's f32 partial.
template <bool PACKED, int PW, int CW>
__global__ void __launch_bounds__(kThreads, 1)
qmm_t_tc(const __nv_bfloat16* __restrict__ pieces, const uint8_t* __restrict__ codes,
         float* __restrict__ dst, int M, int K, int N, int n_chunk, int pw, int cw) {
  using S = Smem<PACKED>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base_u32 = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (base_u32 & 1023)) & 1023);
  auto stage = [&](int s) { return smem + s * S::STAGE; };
  auto bs = [&](int b) { return smem + STAGES * S::STAGE + b * BS; };

  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int n_begin = blockIdx.z * n_chunk;
  const int n_end = min(N, n_begin + n_chunk);
  const int tiles = n_end > n_begin ? (n_end - n_begin + BK - 1) / BK : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  // a tile of 64 rows or fewer gives each warpgroup one column half of
  // those rows (acc[0, 64)), else its own 64 rows and both halves
  const bool n_split = M - m0 <= 64;

  float acc[128], t[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) t[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      load_stage<PACKED, PW, CW>(stage(s), pieces, codes, M, K, N, m0, k0, n_begin + s * BK,
                                 n_end, pw, cw);
    tc::cp_async_commit();
  }
  // step kt: convert code tile kt while step kt − 1's last MMAs run, add
  // their sum, refill the slot that tile kt − 1 held, then tile kt's first
  // half (summed at once) and second half (left running), or a split-N
  // tile's one half (left running)
  for (int kt = 0; kt < tiles; ++kt) {
    tc::cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();                   // ... for every thread
    convert_codes<PACKED>(stage(kt % STAGES) + 3 * AS, bs(kt & 1));
    if (kt > 0) {
      if (n_split) add_product(acc, t);
      else add_product(acc + 64, t);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();                   // tile kt converted; step kt − 1's MMAs done
    const int nxt = kt + STAGES - 1;
    if (nxt < tiles)
      load_stage<PACKED, PW, CW>(stage(nxt % STAGES), pieces, codes, M, K, N, m0, k0,
                                 n_begin + nxt * BK, n_end, pw, cw);
    tc::cp_async_commit();
    const uint32_t a = tc::smem_u32(stage(kt % STAGES)), b = tc::smem_u32(bs(kt & 1));
    if (n_split) {
      mma_half(t, a, b, 0, wg);
    } else {
      mma_half(t, a, b, wg, 0);
      add_product(acc, t);
      mma_half(t, a, b, wg, 1);
    }
  }
  if (tiles > 0) {
    if (n_split) add_product(acc, t);
    else add_product(acc + 64, t);
  }
  tc::cp_async_wait<0>();

  // accumulator i of a thread: row (warp mod 4)·16 + lane/4 (+ 8 for the
  // odd pair) of its 64 rows (wg·64 on, or 0 in a split-N tile), column
  // 8·(i/4) + 2·(lane mod 4) + (i mod 2) (the halves' wgmma layouts side
  // by side; wg·128 on in a split-N tile)
  float* out = dst + (size_t)blockIdx.z * M * K;
  const bool pairs = (K % 2) == 0;
  const int mrow = m0 + (n_split ? 0 : wg * 64) + (warp & 3) * 16 + (lane >> 2);
  const int kcol = k0 + (n_split ? wg * 128 : 0) + (lane & 3) * 2;
#pragma unroll
  for (int nb = 0; nb < 32; ++nb) {
    if (n_split && nb >= 16) break;
    const int k = kcol + nb * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mrow + h * 8;
      if (m >= M || k >= K) continue;
      const float v0 = acc[4 * nb + 2 * h], v1 = acc[4 * nb + 2 * h + 1];
      float* p = out + (size_t)m * K + k;
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (k + 1 < K) p[1] = v1;
      }
    }
  }
}

}  // namespace tct

// two values of v → the bf16 pairs of their three pieces: hi = bf16(v),
// mid = bf16(v − hi), lo = bf16(v − hi − mid), each subtraction exact in f32
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

// v = g · scale (one f32 rounding, __fmul_rn: never fused into the
// subtractions) → its three bf16 pieces, into the (M, N) planes hi, mid,
// lo of pieces. Thread: 8 consecutive columns of a row (16-byte stores
// where N and the bases allow, vec), the scales read once for all of its
// rows (grid.y strides the rows)
template <typename GT>
__global__ void __launch_bounds__(256)
qmm_t_split(const GT* __restrict__ g, const float* __restrict__ scale,
            __nv_bfloat16* __restrict__ pieces, int M, int N, int vec) {
  const int n = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (n >= N) return;
  const size_t mn = (size_t)M * N;
  float s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = n + e < N ? scale[n + e] : 0.f;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const size_t i = (size_t)m * N + n;
    float x[8];
    if (vec && sizeof(GT) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(g + i);
      const float4 b = *reinterpret_cast<const float4*>(g + i + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = n + e < N ? to_f32(g[i + e]) : 0.f;
    }
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split_pair(__fmul_rn(x[2 * j], s[2 * j]), __fmul_rn(x[2 * j + 1], s[2 * j + 1]), hi[j],
                 mid[j], lo[j]);
    if (vec) {
      *reinterpret_cast<uint4*>(pieces + i) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(pieces + mn + i) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
      *reinterpret_cast<uint4*>(pieces + 2 * mn + i) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      const uint32_t* planes[3] = {hi, mid, lo};
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < N)
            reinterpret_cast<uint16_t*>(pieces)[p * mn + i + e] =
                static_cast<uint16_t>(planes[p][e / 2] >> (16 * (e % 2)));
    }
  }
}

template <typename GT, bool PACKED, int MB>
cudaError_t launch_stream_as(const GT* g, const uint8_t* codes, const float* scale, float* dx,
                             int M, int K, int N, cudaStream_t stream) {
  constexpr int smem = streaming::smem_bytes(MB);
  static unsigned long long opted_in = 0;
  auto kernel = streaming::qmm_t_stream<GT, PACKED, MB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
    if (err != cudaSuccess) return err;
  }
  const int vec = PACKED ? 8 : 16;
  const int vec_ok = widest(codes, PACKED ? N / 2 : N, vec) == vec;
  constexpr int rows = streaming::kWarps * streaming::U;   // per block and batch
  const int row_blocks = (K + rows - 1) / rows;
  const dim3 grid(row_blocks < streaming::BLOCKS ? row_blocks : streaming::BLOCKS,
                  (M + MB - 1) / MB);
  kernel<<<grid, streaming::kThreads, smem, stream>>>(g, codes, scale, dx, M, K, N, vec_ok);
  return cudaGetLastError();
}

template <typename GT, bool PACKED>
cudaError_t launch_stream(const GT* g, const uint8_t* codes, const float* scale, float* dx,
                          int M, int K, int N, cudaStream_t s) {
  if (M <= 1) return launch_stream_as<GT, PACKED, 1>(g, codes, scale, dx, M, K, N, s);
  if (M <= 4) return launch_stream_as<GT, PACKED, 4>(g, codes, scale, dx, M, K, N, s);
  return launch_stream_as<GT, PACKED, streaming::MAX_MB>(g, codes, scale, dx, M, K, N, s);
}

template <bool PACKED, int PW, int CW>
cudaError_t launch_tct_as(const __nv_bfloat16* pieces, const uint8_t* codes, float* dst, int M,
                          int K, int N, int n_chunk, dim3 grid, int pw, int cw,
                          cudaStream_t stream) {
  constexpr int smem = tct::Smem<PACKED>::BYTES;
  static unsigned long long opted_in = 0;
  auto kernel = tct::qmm_t_tc<PACKED, PW, CW>;
  const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tct::kThreads, smem, stream>>>(pieces, codes, dst, M, K, N, n_chunk, pw, cw);
  return cudaGetLastError();
}

// the split into pieces, then the product; 16-byte copies of both
// operands (the main paths) run an instance with the widths built in
// (the one that switches on them at run time took 9-20 % longer at M
// 2048, PERF.md §6), any other alignment the latter
template <typename GT, bool PACKED>
cudaError_t launch_tct(const GT* g, const uint8_t* codes, const float* scale,
                       __nv_bfloat16* pieces, float* dst, int M, int K, int N, int n_chunk,
                       dim3 grid, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const int vec = N % 8 == 0 && widest(g, 8LL * sizeof(GT), 16) == 16 &&
                  widest(pieces, 16, 16) == 16;
  const dim3 split_grid((N + 8 * 256 - 1) / (8 * 256), M < 65535 ? M : 65535);
  qmm_t_split<GT><<<split_grid, 256, 0, stream>>>(g, scale, pieces, M, N, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a piece plane's rows, and the planes, must both allow the width
  const int pw = widest(pieces, 2LL * N | 2LL * mn, 16);
  const int cw = widest(codes, PACKED ? N / 2 : N, 16);
  if (pw == 16 && cw == 16)
    return launch_tct_as<PACKED, 16, 16>(pieces, codes, dst, M, K, N, n_chunk, grid, pw, cw,
                                         stream);
  return launch_tct_as<PACKED, 0, 0>(pieces, codes, dst, M, K, N, n_chunk, grid, pw, cw,
                                     stream);
}

template <typename GT>
cudaError_t launch_core(int core, const GT* g, const uint8_t* codes, int packed,
                        const float* scale, __nv_bfloat16* pieces, float* dst, int M, int K,
                        int N, int splits, int n_chunk, cudaStream_t s) {
  if (core == kCoreStream)
    return packed ? launch_stream<GT, true>(g, codes, scale, dst, M, K, N, s)
                  : launch_stream<GT, false>(g, codes, scale, dst, M, K, N, s);
  const dim3 grid((M + tct::BM - 1) / tct::BM, (K + tct::BN - 1) / tct::BN, splits);
  return packed
             ? launch_tct<GT, true>(g, codes, scale, pieces, dst, M, K, N, n_chunk, grid, s)
             : launch_tct<GT, false>(g, codes, scale, pieces, dst, M, K, N, n_chunk, grid, s);
}

}  // namespace

// dx (M, K) f32 = g (M, N) · dequant(codes, scale)ᵀ on plan's core (0
// streaming, 1 tensor cores), the contraction N in `splits` slices of
// n_chunk columns. g_bf16 selects the g type (else f32); packed selects
// (K, N/2) uint8 int4 codes (else (K, N) int8); scale has N entries; part
// is a (splits, M, K) f32 scratch plane when splits > 1, pieces a
// (3, M, N) bf16 scratch for the tensor-core core. All arrays contiguous.
// A split that leaves N uncovered or a slice empty is refused
// (cudaErrorInvalidValue), as is a split of the streaming core or an
// n_chunk that is not a whole number of the tensor cores' steps. Returns
// the cudaError_t of the launches (0 = success).
extern "C" int qmm_t_launch(const void* g, int g_bf16, const void* codes, int packed,
                            const float* scale, float* out, float* part, void* pieces, int M,
                            int K, int N, int core, int splits, int n_chunk, void* stream) {
  if (n_chunk < 1 || splits < 1 || (long long)splits * n_chunk < N ||
      (long long)(splits - 1) * n_chunk >= N)
    return cudaErrorInvalidValue;
  if (!(core == kCoreStream && splits == 1) && !(core == kCoreTc && n_chunk % tct::BK == 0))
    return cudaErrorInvalidValue;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  __nv_bfloat16* pc = static_cast<__nv_bfloat16*>(pieces);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? part : out;
  const cudaError_t err =
      g_bf16 ? launch_core(core, static_cast<const __nv_bfloat16*>(g), c, packed, scale, pc,
                           dst, M, K, N, splits, n_chunk, s)
             : launch_core(core, static_cast<const float*>(g), c, packed, scale, pc, dst, M, K,
                           N, splits, n_chunk, s);
  if (err != cudaSuccess || splits == 1) return err;
  const long long mk = (long long)M * K;
  splitk_reduce<<<(unsigned)((mk + 255) / 256), 256, 0, s>>>(part, out, splits, mk);
  return cudaGetLastError();
}

extern "C" const char* qmm_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
