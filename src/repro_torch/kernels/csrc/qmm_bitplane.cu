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
// slice_planes(k) view is served by passing its first k + 1 planes, and
// only those planes are read.
//
// Two cores, chosen by kernels/qmm_bitplane.py · plan from x's dtype alone
// and never here, with a K split that plan takes from (K, N) alone. No M
// enters either choice, and every row of x is summed on its own in the
// same order whatever M is, so a decode step (M = the slots, 4), the
// speculative verify window (4 slots × 4 rows = 16) and every prompt
// bucket of a prefill compute a row bit for bit alike: the verify window
// accepts a draft at the serving bits exactly when sequential decode
// would have produced it. The split-K partials land in a (splits, M, N)
// scratch plane that splitk_reduce_scale sums in split order.
//
// * bf16 x — the tensor-core core (kCoreTc), at every M. A signed
//   magnitude lies in −255..255, exact in bf16, and scale · 2^−k comes
//   after the contraction, so bf16 tensor cores with f32 accumulation
//   compute this function exactly. What bounds it on an H100: at decode
//   and in the verify window the code words over HBM bandwidth (2·M·K·N
//   operations against K·N·P/8 bytes, far below the card's ~295
//   operations per byte: a weight-streaming GEMV, linear in the planes
//   served — an 8-bit artifact streams 9/8 bytes per weight, its 4-bit
//   view 5/8); at prefill (M ≤ 128) still the code bytes, but the bits
//   must also be expanded into one bf16 per weight (~5 integer operations
//   each) and a 128-row tile runs its MMAs. The first port's SIMT kernel
//   expanded the bits once per 4 rows of x (28 times per weight at M 112)
//   on the f32 pipe. Here each word tile is expanded once per block.
//   wgmma_tile.cuh's 128 × 256 output tile (one tile row holds every
//   prompt bucket, M ≤ 128), K steps of 64, a 4-deep cp.async ring of x
//   tiles (the tile's rows of x only; the rows the MMAs read past them are
//   zeroed once) and of the P planes' word tiles (16-byte copies where the
//   base and the row stride allow, else 8 or 4 bytes). The expansion is a
//   bit transpose in registers: a thread takes the 8 magnitude words of
//   one 32-column word (zero past the planes passed, so the magnitude sits
//   in the high bits of a byte and the scale multiplies by 2^−8) and
//   transposes each 8 × 8 bit block with 12 masked swaps (shift + LOP3
//   each way), so that byte q of word r is column 8q + r's magnitude; a
//   byte permute and an FADD turn a byte into an exact f32 (2²³ + byte,
//   less 2²³), a second permute packs two f32s' high halves into a bf16
//   pair, and one LOP3 ORs in the two sign bits. Pairs hold columns
//   (r, 16 + r) and (8 + r, 24 + r), so a B tile's columns are a fixed
//   permutation of y's within each 32-column word; the epilogue puts each
//   accumulator back in its column. Step kt converts word tile kt into the
//   MN-major swizzled bf16 layout that wgmma reads while step kt − 1's
//   MMAs run, then starts tile kt's: a load has three steps to land, and
//   the loads in flight set the pace (a block reading contiguous memory is
//   no faster; a 3-deep ring is slower). A tile of 64 rows of x
//   or fewer (decode, the verify window, buckets 48 and 64) runs both
//   warpgroups on its 64 rows, one 128-column half each, at once; a taller
//   tile gives each warpgroup 64 rows and both halves, the second after
//   the first's sum. An output element is the same wgmma steps either way,
//   so its bits do not depend on the tile's height. The tensor cores' f32
//   accumulation rounds toward zero, so each K step's 64-term product
//   starts from zero and is added to the f32 accumulators by
//   round-to-nearest FADDs. The epilogue stages the f32 tile in shared
//   memory in y's column order and writes whole rows with 16-byte stores.
//   One block per SM (~201 KB of dynamic shared memory at 9 planes, opted
//   in per device); K is split until one wave of blocks fills the card:
//   gate/up (64 column tiles) in 2, q/o and down (8) and k/v (1) in 16.
//
// * f32 x — the SIMT core (kCoreSimt), unchanged from the first port: f32
//   products are what rel 1e-5 needs there. Each thread owns one 32-column
//   word of every plane row, so a warp reads 32 consecutive words (128
//   bytes) of each plane; the integer ±mag is rebuilt in registers and
//   Σ x·(±mag) accumulates in f32 for 4 rows of x per block, with
//   scale·2^−k applied once after the contraction. Eight warps stride the
//   K rows of a block.
//
// Ragged M, K and N are masked inside both cores; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int kCoreSimt = 0;   // the ids of kernels/qmm_bitplane.py's CORES
constexpr int kCoreTc = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }

// ------------------------------------------------------- the SIMT core

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 4;            // rows of x per block
constexpr int kKSub = 128;        // k rows of x staged in shared memory at a time
constexpr int kBN = 32 * 32;      // columns per block: one 32-column word per lane

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

}  // namespace simt

// -------------------------------------------------- the tensor-core core

namespace tc {

constexpr int STAGES = 4;                   // cp.async ring of x and word tiles
constexpr int BBUF = 2;                     // converted tiles: step kt reads one, kt + 1's is written
constexpr int TW = BN / 32;                 // words of a tile row in one plane (8)
constexpr int PLANE_TILE = BK * TW * 4;     // bytes of one plane's words of one K step
constexpr int XS = BM * ROW;                // one x tile, bf16, 128B-swizzled
constexpr int BS = BK * BN * 2;             // one converted B tile, bf16
constexpr int MAX_PLANES = 9;
constexpr int TILE_LD = BN + 4;             // f32 output tile row in shared memory, padded
constexpr float kPost = 1.0f / 256.0f;      // a magnitude byte is mag · 2^(8−k)

constexpr int smem_bytes(int planes) {      // + 1024 for the alignment
  return 1024 + STAGES * (XS + planes * PLANE_TILE) + BBUF * BS;
}

// byte b of row r of a plane's word tile (32-byte rows); the rows 4..7 of
// every 8 swap their two 16-byte halves, so that a warp's word reads (8
// rows × 4 words) hit 32 distinct banks
__device__ __forceinline__ int raw_at(int r, int b) {
  return r * (TW * 4) + (b ^ ((r & 4) << 2));
}

// planes[0 .. P, k0 .. k0+BK, w0 .. w0+TW] → raw, in W-byte pieces by
// cp.async (W ∈ 16/8/4); rows ≥ k_end and words past the row read as 0
template <int W>
__device__ __forceinline__ void load_planes(uint8_t* raw, const uint32_t* planes, int P, int K,
                                            int row_words, int w0, int k0, int k_end) {
  constexpr int PER_ROW = TW * 4 / W;
  const int row_bytes = row_words * 4;
  for (int i = threadIdx.x; i < P * BK * PER_ROW; i += kThreads) {
    const int p = i / (BK * PER_ROW), rem = i % (BK * PER_ROW);
    const int r = rem / PER_ROW, c = rem % PER_ROW;
    const int k = k0 + r, b = w0 * 4 + c * W;
    const int valid = (k < k_end) ? min(max(row_bytes - b, 0), W) : 0;
    uint8_t* d = raw + p * PLANE_TILE + raw_at(r, c * W);
    const uint8_t* s =
        reinterpret_cast<const uint8_t*>(planes + ((size_t)p * K + k) * row_words) + b;
    if (valid) cp_async<W>(smem_u32(d), s, valid);
    else zero_piece<W>(d);
  }
}

// x[m0 .. m0+rows, k0 .. k0+BK] → xs (K-major, swizzled) as wgmma_tile.cuh's
// load_x copies it, for the tile's rows of x only (columns ≥ k_end read as
// 0); the rows past them are zeroed once per block
template <int W>
__device__ __forceinline__ void load_x_rows(uint8_t* xs, const __nv_bfloat16* x, int rows,
                                            int K, int m0, int k0, int k_end) {
  constexpr int E = W / 2;             // bf16 per piece
  constexpr int PER_ROW = BK / E;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const int k = k0 + c * E;
    const int valid = 2 * min(max(k_end - k, 0), E);
    uint8_t* d = xs + swz(r, c * W);
    const __nv_bfloat16* s = x + (size_t)(m0 + r) * K + k;
    if constexpr (W >= 4) {
      if (valid) cp_async<W>(smem_u32(d), s, valid);
      else zero_piece<W>(d);
    } else {
      *reinterpret_cast<uint16_t*>(d) = valid ? *reinterpret_cast<const uint16_t*>(s) : 0;
    }
  }
}

// XW, CW: the piece widths when known at compile time (the aligned
// instance), 0 to switch on xw, cw at run time
template <int XW, int CW>
__device__ __forceinline__ void load_stage(uint8_t* xs, uint8_t* raw, const __nv_bfloat16* x,
                                           const uint32_t* planes, int rows, int K, int P,
                                           int row_words, int m0, int w0, int k0, int k_end,
                                           int xw, int cw) {
  if constexpr (XW != 0) {
    load_x_rows<XW>(xs, x, rows, K, m0, k0, k_end);
    load_planes<CW>(raw, planes, P, K, row_words, w0, k0, k_end);
    return;
  }
  switch (xw) {
    case 16: load_x_rows<16>(xs, x, rows, K, m0, k0, k_end); break;
    case 8: load_x_rows<8>(xs, x, rows, K, m0, k0, k_end); break;
    case 4: load_x_rows<4>(xs, x, rows, K, m0, k0, k_end); break;
    default: load_x_rows<2>(xs, x, rows, K, m0, k0, k_end); break;
  }
  switch (cw) {
    case 16: load_planes<16>(raw, planes, P, K, row_words, w0, k0, k_end); break;
    case 8: load_planes<8>(raw, planes, P, K, row_words, w0, k0, k_end); break;
    default: load_planes<4>(raw, planes, P, K, row_words, w0, k0, k_end); break;
  }
}

// one level of the 8 × 8 bit transpose: the bits of a under LO << S and
// the bits of b under LO trade places
template <int S, uint32_t LO>
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b) {
  constexpr uint32_t HI = LO << S;
  const uint32_t na = (a & ~HI) | ((b << S) & HI);
  b = (b & ~LO) | ((a >> S) & LO);
  a = na;
}

// byte Q of t (a magnitude 0..255) as the bits of an exact f32
template <int Q>
__device__ __forceinline__ uint32_t byte_f32(uint32_t t) {
  return __float_as_uint(__uint_as_float(__byte_perm(t, 0x4B000000u, 0x7440 | Q)) - 8388608.f);
}

__device__ __forceinline__ void st16(uint8_t* p, const uint32_t* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// a landed word tile (P planes × BK rows × TW words) → the bf16 B tile,
// once per block. Item (k, w): one 32-column word of row k; a warp's
// quarter holds 8 consecutive rows of one word, so its 16-byte stores
// fall in 8 distinct chunks of the swizzle. MAGS (4 or 8) magnitude planes
// at most: the planes past P, and past MAGS, read as 0. Physical chunk c
// of word w holds the pairs A_{4c..4c+3} (c < 2: columns r, 16 + r) or
// B_{4(c−2)..} (columns 8 + r, 24 + r): column map in the epilogue.
template <int MAGS>
__device__ __forceinline__ void convert(const uint8_t* raw, uint8_t* bs, int P) {
#pragma unroll
  for (int i = threadIdx.x; i < BK * TW; i += kThreads) {
    const int w = (i >> 3) & (TW - 1), k = ((i >> 6) << 3) | (i & 7);
    const int off = raw_at(k, w * 4);
    const uint32_t s = *reinterpret_cast<const uint32_t*>(raw + off);
    uint32_t b[8];   // b[c]: the plane of bit c of a magnitude byte (plane 1, the MSB, is bit 7)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int plane = 8 - c;
      b[c] = (plane <= MAGS && plane < P)
                 ? *reinterpret_cast<const uint32_t*>(raw + plane * PLANE_TILE + off) : 0u;
    }
    // transpose every 8 × 8 bit block (byte q of b[0..7]): after it, byte q
    // of b[r] is the magnitude byte of column 8q + r
#pragma unroll
    for (int r = 0; r < 4; ++r) swap_bits<4, 0x0F0F0F0Fu>(b[r], b[r + 4]);
    swap_bits<2, 0x33333333u>(b[0], b[2]);
    swap_bits<2, 0x33333333u>(b[1], b[3]);
    swap_bits<2, 0x33333333u>(b[4], b[6]);
    swap_bits<2, 0x33333333u>(b[5], b[7]);
#pragma unroll
    for (int r = 0; r < 8; r += 2) swap_bits<1, 0x55555555u>(b[r], b[r + 1]);

    uint8_t* row = bs + (k >> 3) * B_SBO + (w >> 1) * B_LBO + (k & 7) * ROW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * half + j;
        // bf16 pairs (col r, col 16 + r) and (col 8 + r, col 24 + r): the
        // f32s' high halves, exact for integers < 2^8, with the sign bits
        // of those columns moved to bits 15 and 31
        lo[j] = __byte_perm(byte_f32<0>(b[r]), byte_f32<2>(b[r]), 0x7632) |
                ((s << (15 - r)) & 0x80008000u);
        hi[j] = __byte_perm(byte_f32<1>(b[r]), byte_f32<3>(b[r]), 0x7632) |
                ((s << (7 - r)) & 0x80008000u);
      }
      st16(row + ((((4 * (w & 1) + half) ^ k) & 7) << 4), lo);
      st16(row + ((((4 * (w & 1) + 2 + half) ^ k) & 7) << 4), hi);
    }
  }
}

// t = one K step (64) of this warpgroup's 64 rows × a 128-column B half,
// from zero, asynchronously
__device__ __forceinline__ void mma_half(float* t, uint32_t a0, uint32_t b0) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    wgmma_step(t, desc(a0 + ks * 32, 16, 1024), desc(b0 + ks * 2 * B_SBO, B_LBO, B_SBO), ks);
  wgmma_commit();
}
// wait for t and add it to 64 accumulators with round-to-nearest FADDs
__device__ __forceinline__ void add_product(float* acc, float* t) {
  wgmma_wait<0>();
  pin(t);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += t[i];
}

// One 128 × 256 output tile over the block's K range (the design notes are
// at the top of this file): y scaled with one K slice, else this slice's
// raw partial.
template <int MAGS, int XW, int CW>
__global__ void __launch_bounds__(kThreads, 1)
qmm_bitplane_tc(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ planes,
                const float* __restrict__ scale, float* __restrict__ dst, int M, int K, int N,
                int P, int k_chunk, int xw, int cw) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base_u32 = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (base_u32 & 1023)) & 1023);
  const int raws = P * PLANE_TILE;
  auto xs = [&](int s) { return smem + s * XS; };
  auto bs = [&](int b) { return smem + STAGES * XS + b * BS; };
  auto raw = [&](int s) { return smem + STAGES * XS + BBUF * BS + s * raws; };

  const int row_words = (N + 31) / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, w0 = n0 / 32;
  const int rows = min(BM, M - m0);
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const bool n_split = rows <= 64;
  const uint32_t a_off = n_split ? 0 : wg * 64 * ROW;      // this warpgroup's rows of x
  const uint32_t b_off = n_split ? wg * 2 * B_LBO : 0;     // ... and its first B half

  float acc[128], t[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) t[i] = 0.f;

  // the x rows that the MMAs read and no row of x fills: zero, once
  const int a_rows = n_split ? 64 : BM;
  for (int i = threadIdx.x; i < STAGES * (a_rows - rows) * 8; i += kThreads) {
    const int s = i / ((a_rows - rows) * 8), rem = i % ((a_rows - rows) * 8);
    zero_piece<16>(xs(s) + swz(rows + rem / 8, (rem % 8) * 16));
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      load_stage<XW, CW>(xs(s), raw(s), x, planes, rows, K, P, row_words, m0, w0,
                         k_begin + s * BK, k_end, xw, cw);
    cp_async_commit();
  }
  // step kt: convert tile kt while step kt − 1's MMAs run, add their sum,
  // refill the slot step kt − 1 read, and start tile kt's MMAs (a taller
  // tile's second B half runs on its own, after the first half's sum)
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... for every thread
    convert<MAGS>(raw(kt % STAGES), bs(kt % BBUF), P);
    if (kt > 0) {
      add_product(acc, t);
      if (!n_split) {
        mma_half(t, smem_u32(xs((kt - 1) % STAGES)) + a_off,
                 smem_u32(bs((kt - 1) % BBUF)) + 2 * B_LBO);
        add_product(acc + 64, t);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();               // tile kt converted; step kt − 1's MMAs done
    const int nxt = kt + STAGES - 1;
    if (nxt < tiles)
      load_stage<XW, CW>(xs(nxt % STAGES), raw(nxt % STAGES), x, planes, rows, K, P, row_words,
                         m0, w0, k_begin + nxt * BK, k_end, xw, cw);
    cp_async_commit();
    mma_half(t, smem_u32(xs(kt % STAGES)) + a_off, smem_u32(bs(kt % BBUF)) + b_off);
  }
  if (tiles > 0) {
    add_product(acc, t);
    if (!n_split) {
      mma_half(t, smem_u32(xs((tiles - 1) % STAGES)) + a_off,
               smem_u32(bs((tiles - 1) % BBUF)) + 2 * B_LBO);
      add_product(acc + 64, t);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // every wgmma and conversion is done: the ring is free

  // the accumulators → an f32 tile in shared memory, in y's column order.
  // Accumulator i of a thread: row (warp mod 4)·16 + lane/4 (+ 8 for the
  // odd pair) of its warpgroup's rows, B column 8·nb + 2·(lane mod 4) +
  // (i mod 2) with nb = i/4 (+ 16 for warpgroup 1 of a split-N tile); B
  // chunk c of 32-column word g holds y's columns 32g + 4·(c mod 2) +
  // 8·(c/2) + t and, in the high halves, 16 further
  float* tile = reinterpret_cast<float*>(smem);
  const int r0 = (n_split ? 0 : wg * 64) + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    if (n_split && i >= 64) break;
    const int nb = (i >> 2) + (n_split ? 16 * wg : 0);
    const int col = 32 * (nb >> 2) + 4 * (nb & 1) + 8 * ((nb >> 1) & 1) + (lane & 3) +
                    16 * (i & 1);
    tile[(r0 + 8 * ((i >> 1) & 1)) * TILE_LD + col] = acc[i];
  }
  __syncthreads();

  // write the tile out, 4 columns per thread and row: scaled into y with
  // one K slice, else as this slice's raw partial
  const bool vec = (N & 3) == 0;
  const bool scaled = gridDim.z == 1;
  float* o_base = dst + (size_t)blockIdx.z * M * N;
  for (int i = threadIdx.x; i < rows * (BN / 4); i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4, n = n0 + c;
    if (n >= N) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = tile[r * TILE_LD + c + e];
      if (scaled && n + e < N) v[e] *= scale[n + e] * kPost;
    }
    float* o = o_base + (size_t)(m0 + r) * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) o[e] = v[e];
    }
  }
}

}  // namespace tc

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
cudaError_t launch_simt_as(const void* x, const uint32_t* planes, const float* scale,
                           float* dst, int M, int K, int N, int splits, int k_chunk,
                           cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const float post = 1.0f / static_cast<float>(1 << (P - 1));  // 2^−k, exact
  dim3 grid((N + simt::kBN - 1) / simt::kBN, (M + simt::kBM - 1) / simt::kBM, splits);
  simt::qmm_bitplane_kernel<XT, P><<<grid, simt::kThreads, 0, stream>>>(
      static_cast<const XT*>(x), planes, scale, dst, M, K, N, W, k_chunk, post);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_simt(const void* x, const uint32_t* planes, int n_planes,
                        const float* scale, float* dst, int M, int K, int N, int splits,
                        int k_chunk, cudaStream_t s) {
  switch (n_planes) {
    case 1: return launch_simt_as<XT, 1>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 2: return launch_simt_as<XT, 2>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 3: return launch_simt_as<XT, 3>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 4: return launch_simt_as<XT, 4>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 5: return launch_simt_as<XT, 5>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 6: return launch_simt_as<XT, 6>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 7: return launch_simt_as<XT, 7>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 8: return launch_simt_as<XT, 8>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    case 9: return launch_simt_as<XT, 9>(x, planes, scale, dst, M, K, N, splits, k_chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int MAGS, int XW, int CW>
cudaError_t launch_tc_as(const __nv_bfloat16* x, const uint32_t* planes, const float* scale,
                         float* dst, int M, int K, int N, int P, int k_chunk, dim3 grid,
                         int xw, int cw, cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const cudaError_t err =
      opt_in_smem(tc::qmm_bitplane_tc<MAGS, XW, CW>, tc::smem_bytes(tc::MAX_PLANES), opted_in);
  if (err != cudaSuccess) return err;
  tc::qmm_bitplane_tc<MAGS, XW, CW><<<grid, tc::kThreads, tc::smem_bytes(P), stream>>>(
      x, planes, scale, dst, M, K, N, P, k_chunk, xw, cw);
  return cudaGetLastError();
}

// 16-byte copies of both operands (the main paths) run an instance with
// the widths built in; any other alignment, the one that switches on them
template <int MAGS>
cudaError_t launch_tc(const __nv_bfloat16* x, const uint32_t* planes, const float* scale,
                      float* dst, int M, int K, int N, int P, int k_chunk, int splits,
                      cudaStream_t stream) {
  const dim3 grid((M + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN, splits);
  const int xw = widest(x, 2LL * K, 16), cw = widest(planes, 4LL * ((N + 31) / 32), 16);
  if (xw == 16 && cw == 16)
    return launch_tc_as<MAGS, 16, 16>(x, planes, scale, dst, M, K, N, P, k_chunk, grid, xw,
                                      cw, stream);
  return launch_tc_as<MAGS, 0, 0>(x, planes, scale, dst, M, K, N, P, k_chunk, grid, xw, cw,
                                  stream);
}

}  // namespace

// y (M, N) f32 = x (M, K) · decode(planes (n_planes, K, ⌈N/32⌉) uint32,
// scale (N,) f32) on plan's core (0 SIMT, 1 tensor cores), K in `splits`
// slices of k_chunk rows. x_bf16 selects the x type (else f32); part is a
// (splits, M, N) f32 scratch plane when splits > 1. A split that leaves K
// uncovered or a slice empty is refused (cudaErrorInvalidValue), as is a
// core for the other x type (tensor cores: bf16; SIMT: f32) or a k_chunk
// that is not a whole number of the tensor cores' K steps. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int qmm_bitplane_launch(const void* x, int x_bf16, const void* planes, int n_planes,
                                   const float* scale, float* out, float* part, int M, int K,
                                   int N, int core, int splits, int k_chunk, void* stream) {
  if (n_planes < 1 || n_planes > tc::MAX_PLANES || k_chunk < 1 || splits < 1 ||
      (long long)splits * k_chunk < K || (long long)(splits - 1) * k_chunk >= K)
    return cudaErrorInvalidValue;
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? part : out;
  float post;
  cudaError_t err;
  if (core == kCoreTc) {
    if (!x_bf16 || k_chunk % tc::BK) return cudaErrorInvalidValue;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    post = tc::kPost;
    err = n_planes <= 5 ? launch_tc<4>(xb, p, scale, dst, M, K, N, n_planes, k_chunk, splits, s)
                        : launch_tc<8>(xb, p, scale, dst, M, K, N, n_planes, k_chunk, splits, s);
  } else if (core == kCoreSimt && !x_bf16) {
    post = 1.0f / static_cast<float>(1 << (n_planes - 1));
    err = launch_simt<float>(x, p, n_planes, scale, dst, M, K, N, splits, k_chunk, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  splitk_reduce_scale<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, scale, out, splits,
                                                                   N, mn, post);
  return cudaGetLastError();
}

extern "C" const char* qmm_bitplane_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
