// qmm_core.cuh — the dequantize-matmul product y = x · (codes ⊙ scale) that
// csrc/qmm.cu (kernel B5) and csrc/qmm_qout.cu (kernel B7) both compile:
// one source of the same arithmetic in both libraries, so that qmm_qout's
// product equals qmm's bit for bit (the fused epilogue then equals qmm →
// cast → encode). The design notes are in qmm.cu.
//
// Two cores, chosen by the caller (kernels/qmm.py · plan) and never here:
//   kCoreSimt — f32 FMAs on the CUDA cores, streaming the code bytes: the
//               decode path (M ≤ plan's threshold) and f32 x at any M;
//   kCoreTc   — bf16 tensor cores (wgmma m64n128k16, f32 accumulators):
//               bf16 x above the threshold (prefill, training).
// Both write, for each K split z of the grid, the f32 partial
// dst[z] = x[:, Kz] · codes[Kz, :] · scale to a (splits, M, N) plane (with
// one split, y itself); splitk_reduce sums the partials in split order, so
// results are deterministic. The tensor-core tile's copies, swizzle and
// wgmma steps are in wgmma_tile.cuh, shared with csrc/qmm_bitplane.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int kCoreSimt = 0;   // the ids of kernels/qmm.py's CORES
constexpr int kCoreTc = 1;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// one 32-bit word of codes → its 4 int8 / 8 int4 values (int4: even column
// in the low nibble)
template <bool PACKED>
__device__ __forceinline__ void decode_word(uint32_t word, float* w) {
  if constexpr (PACKED) {
    const uint32_t lo = word & 0x0F0F0F0Fu, hi = (word >> 4) & 0x0F0F0F0Fu;
    w[0] = nib_at<0>(lo); w[1] = nib_at<0>(hi);
    w[2] = nib_at<1>(lo); w[3] = nib_at<1>(hi);
    w[4] = nib_at<2>(lo); w[5] = nib_at<2>(hi);
    w[6] = nib_at<3>(lo); w[7] = nib_at<3>(hi);
  } else {
    const uint32_t u = word ^ 0x80808080u;
    w[0] = int8_at<0>(u); w[1] = int8_at<1>(u);
    w[2] = int8_at<2>(u); w[3] = int8_at<3>(u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------- the SIMT core

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int BM = 4;          // rows of x per block
constexpr int C = 16;          // columns per lane: one 16-byte (int8) / 8-byte (int4) load
constexpr int BN = 32 * C;     // columns per block (kernels/qmm.py · TILES)
constexpr int KSUB = 256;      // k rows of x staged in shared memory at a time

template <bool PACKED> struct Raw;
template <> struct Raw<false> { using T = uint4; static constexpr int U = 4; };
template <> struct Raw<true> { using T = uint2; static constexpr int U = 8; };

// one lane's code bytes of one row: a vector load where the row is aligned
// and whole, else byte loads (bytes past the row read as 0)
template <bool PACKED>
__device__ __forceinline__ typename Raw<PACKED>::T load_raw(const uint8_t* p, bool vec,
                                                           int nbytes) {
  using T = typename Raw<PACKED>::T;
  if (vec) return __ldg(reinterpret_cast<const T*>(p));
  uint32_t b[4] = {};
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i)
    if (i < nbytes) b[i / 4] |= static_cast<uint32_t>(p[i]) << (8 * (i % 4));
  if constexpr (PACKED) return make_uint2(b[0], b[1]);
  else return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ void words_of(const uint4& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void words_of(const uint2& v, uint32_t* w) {
  w[0] = v.x; w[1] = v.y;
}

// Every lane owns C columns and reads one vector of code bytes per k row;
// each warp takes every 8th k row of the block's K range with U rows in
// flight (the loads issued before the FMAs), so a block streams 8·U code
// rows at a time. x is staged as f32 in shared memory, 4 rows side by side
// (one 16-byte read per k row). The warps' partial sums meet in shared
// memory and are added in warp order.
template <typename XT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 2)
qmm_simt(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
         const float* __restrict__ scale, float* __restrict__ dst,
         int M, int K, int N, int k_chunk, int vec_ok) {
  using T = typename Raw<PACKED>::T;
  constexpr int U = Raw<PACKED>::U;
  constexpr int WORDS = sizeof(T) / 4;
  constexpr int PER_WORD = PACKED ? 8 : 4;
  const int row_bytes = PACKED ? N / 2 : N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN + lane * C;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int byte0 = PACKED ? n0 / 2 : n0;
  const bool active = n0 < N;
  const bool vec = vec_ok && (n0 + C <= N);
  const int nbytes = active ? min((int)sizeof(T), row_bytes - byte0) : 0;

  __shared__ float4 xs[KSUB];          // xs[k] = x[m0 .. m0 + 3][k]
  __shared__ float red[kWarps][BN];

  float acc[BM][C];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += KSUB) {
    const int kn = min(KSUB, k_end - ks);
    __syncthreads();
    for (int i = threadIdx.x; i < kn; i += kThreads) {
      float v[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m)
        v[m] = (m0 + m < M) ? to_f32(x[(size_t)(m0 + m) * K + ks + i]) : 0.f;
      xs[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (!active) continue;
    const uint8_t* base = codes + (size_t)ks * row_bytes + byte0;
    for (int kk = warp; kk < kn; kk += kWarps * U) {
      T raw[U] = {};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * kWarps;
        if (k < kn) raw[u] = load_raw<PACKED>(base + (size_t)k * row_bytes, vec, nbytes);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * kWarps;
        if (k >= kn) break;
        const float4 xv = xs[k];
        const float xm[BM] = {xv.x, xv.y, xv.z, xv.w};
        uint32_t words[WORDS];
        words_of(raw[u], words);
#pragma unroll
        for (int q = 0; q < WORDS; ++q) {
          float w[PER_WORD];
          decode_word<PACKED>(words[q], w);
#pragma unroll
          for (int c = 0; c < PER_WORD; ++c)
#pragma unroll
            for (int m = 0; m < BM; ++m)
              acc[m][q * PER_WORD + c] = fmaf(xm[m], w[c], acc[m][q * PER_WORD + c]);
        }
      }
    }
  }

  float sc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sc[c] = (n0 + c < N) ? scale[n0 + c] : 0.f;
  float* out = dst + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(&red[warp][lane * C + c]) =
          make_float4(acc[m][c] * sc[c], acc[m][c + 1] * sc[c + 1],
                      acc[m][c + 2] * sc[c + 2], acc[m][c + 3] * sc[c + 3]);
    __syncthreads();
    if (m0 + m >= M) continue;
    for (int j = threadIdx.x; j < BN; j += kThreads) {
      const int n = blockIdx.x * BN + j;
      if (n < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][j];
        out[(size_t)(m0 + m) * N + n] = s;
      }
    }
  }
}

}  // namespace simt

// -------------------------------------------------- the tensor-core core

namespace tc {

constexpr int STAGES = 4;      // cp.async ring of x and code tiles
constexpr int BBUF = 2;        // converted code tiles: step kt reads one, kt + 1's is written

template <bool PACKED>
struct Smem {
  static constexpr int RAW = PACKED ? BN / 2 : BN;  // code bytes per k row of a tile
  static constexpr int XS = BM * ROW;               // one x tile, bf16, 128B-swizzled
  static constexpr int BS = BK * BN * 2;            // one converted code tile, bf16
  static constexpr int RAWS = BK * RAW;             // one raw code tile
  static constexpr int BYTES = 1024 + STAGES * (XS + RAWS) + BBUF * BS;  // + alignment
};

// codes[k0 .. k0+BK, byte0 .. byte0+RAW] → raw (plain rows), as load_x
// (W ∈ 16/8/4 by cp.async, 2/1 plain); rows ≥ k_end and bytes past the row
// read as 0
template <int W, bool PACKED>
__device__ __forceinline__ void load_codes(uint8_t* raw, const uint8_t* codes,
                                           int row_bytes, int byte0, int k0, int k_end) {
  constexpr int RAW = Smem<PACKED>::RAW;
  constexpr int PER_ROW = RAW / W;
  for (int i = threadIdx.x; i < BK * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const int k = k0 + r, b = byte0 + c * W;
    const int valid = (k < k_end) ? min(max(row_bytes - b, 0), W) : 0;
    uint8_t* d = raw + r * RAW + c * W;
    const uint8_t* s = codes + (size_t)k * row_bytes + b;
    if constexpr (W >= 4) {
      if (valid) cp_async<W>(smem_u32(d), s, valid);
      else zero_piece<W>(d);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j) d[j] = j < valid ? s[j] : 0;
    }
  }
}

// XW, CW: the piece widths when known at compile time (the aligned
// instance), 0 to switch on xw, cw at run time
template <bool PACKED, int XW, int CW>
__device__ __forceinline__ void load_stage(uint8_t* xs, uint8_t* raw, const __nv_bfloat16* x,
                                           const uint8_t* codes, int M, int K, int row_bytes,
                                           int m0, int byte0, int k0, int k_end, int xw,
                                           int cw) {
  if constexpr (XW != 0) {
    load_x<XW>(xs, x, M, K, m0, k0, k_end);
    load_codes<CW, PACKED>(raw, codes, row_bytes, byte0, k0, k_end);
    return;
  }
  switch (xw) {
    case 16: load_x<16>(xs, x, M, K, m0, k0, k_end); break;
    case 8: load_x<8>(xs, x, M, K, m0, k0, k_end); break;
    case 4: load_x<4>(xs, x, M, K, m0, k0, k_end); break;
    default: load_x<2>(xs, x, M, K, m0, k0, k_end); break;
  }
  switch (cw) {
    case 16: load_codes<16, PACKED>(raw, codes, row_bytes, byte0, k0, k_end); break;
    case 8: load_codes<8, PACKED>(raw, codes, row_bytes, byte0, k0, k_end); break;
    case 4: load_codes<4, PACKED>(raw, codes, row_bytes, byte0, k0, k_end); break;
    case 2: load_codes<2, PACKED>(raw, codes, row_bytes, byte0, k0, k_end); break;
    default: load_codes<1, PACKED>(raw, codes, row_bytes, byte0, k0, k_end); break;
  }
}

// a landed code tile (BK rows of raw bytes) → bf16, once per block (every
// int8 and int4 code is exact in bf16), laid out MN-major under the 128B
// swizzle as wgmma reads a transposed B: atoms of 8 k rows × 64 columns
// (1024 bytes), atom (k/8, n/64) at (4·(k/8) + n/64)·1024. Each thread
// turns 16 codes of one row into two 16-byte stores.
template <bool PACKED>
__device__ __forceinline__ void convert(const uint8_t* raw, uint8_t* bs) {
#pragma unroll
  for (int i = threadIdx.x; i < BK * (BN / 16); i += kThreads) {
    const int k = i / (BN / 16), col = (i % (BN / 16)) * 16;
    uint32_t o[8];
    if constexpr (PACKED) {
      const uint2 v = *reinterpret_cast<const uint2*>(raw + k * (BN / 2) + col / 2);
      const uint32_t words[2] = {v.x, v.y};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float w[8];
        decode_word<true>(words[q], w);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[4 * q + j] = pack_bf16x2(w[2 * j], w[2 * j + 1]);
      }
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(raw + k * BN + col);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float w[4];
        decode_word<false>(words[q], w);
        o[2 * q] = pack_bf16x2(w[0], w[1]);
        o[2 * q + 1] = pack_bf16x2(w[2], w[3]);
      }
    }
    uint8_t* atom = bs + (k >> 3) * B_SBO + (col >> 6) * B_LBO;
    const int r = k & 7, c = (col & 63) >> 3;
    *reinterpret_cast<uint4*>(atom + r * ROW + (((c ^ r) & 7) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(atom + r * ROW + ((((c + 1) ^ r) & 7) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// One 128 × 256 output tile over the block's K range. Tiles of x (bf16,
// K-major) and of the raw code bytes land in a STAGES-deep cp.async ring;
// each code tile is converted to bf16 once per block, into one of two
// buffers, one K step ahead of the product, and one barrier per K step
// orders it all. Each warpgroup multiplies its 64 rows by the B tile one
// 128-column half at a time: four asynchronous wgmma m64n128k16 steps from
// zero into t (the first while its threads load and convert the next
// tiles), then t is added to that half's f32 accumulators with FADD. The
// tensor cores' own accumulation rounds toward zero, so it only ever sums
// one K step (64 products); the long sums are rounded to nearest. The
// epilogue scales by scale[n] and writes this split's f32 partial.
template <bool PACKED, int XW, int CW>
__global__ void __launch_bounds__(kThreads, 1)
qmm_tc(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
       const float* __restrict__ scale, float* __restrict__ dst, int M, int K, int N,
       int k_chunk, int xw, int cw) {
  using S = Smem<PACKED>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base_u32 = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (base_u32 & 1023)) & 1023);
  auto xs = [&](int s) { return smem + s * S::XS; };
  auto bs = [&](int b) { return smem + STAGES * S::XS + b * S::BS; };
  auto raw = [&](int s) { return smem + STAGES * S::XS + BBUF * S::BS + s * S::RAWS; };

  const int row_bytes = PACKED ? N / 2 : N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int byte0 = PACKED ? n0 / 2 : n0;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2;

  float acc[128], t[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) t[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles)
      load_stage<PACKED, XW, CW>(xs(s), raw(s), x, codes, M, K, row_bytes, m0, byte0,
                                 k_begin + s * BK, k_end, xw, cw);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (tiles > 0) convert<PACKED>(raw(0), bs(0));

  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<STAGES - 3>();   // tile kt + 1 has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();               // ... for every thread; tile kt converted; step kt − 1 done
    const uint32_t a0 = smem_u32(xs(kt % STAGES)) + wg * 64 * ROW;
    const uint32_t b0 = smem_u32(bs(kt % BBUF));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_step(t, desc(a0 + ks * 32, 16, 1024),
                   desc(b0 + h * 2 * B_LBO + ks * 2 * B_SBO, B_LBO, B_SBO), ks);
      wgmma_commit();
      if (h == 0) {
        const int nxt = kt + STAGES - 1;
        if (nxt < tiles)
          load_stage<PACKED, XW, CW>(xs(nxt % STAGES), raw(nxt % STAGES), x, codes, M, K,
                                     row_bytes, m0, byte0, k_begin + nxt * BK, k_end, xw, cw);
        cp_async_commit();
        if (kt + 1 < tiles) convert<PACKED>(raw((kt + 1) % STAGES), bs((kt + 1) % BBUF));
      }
      wgmma_wait<0>();
      pin(t);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h * 64 + i] += t[i];
    }
  }
  cp_async_wait<0>();

  // accumulator i of a thread: rows (warp mod 4)·16 + lane/4 (+ 8 for the
  // odd pair), columns 8·(i/4) + 2·(lane mod 4) + (i mod 2) (the halves'
  // wgmma layouts side by side)
  float* out = dst + (size_t)blockIdx.z * M * N;
  const bool pairs = (N % 2) == 0;
  const int mrow = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int n = n0 + nb * 8 + (lane & 3) * 2;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mrow + h * 8;
      if (m >= M || n >= N) continue;
      const float v0 = acc[4 * nb + 2 * h] * s0, v1 = acc[4 * nb + 2 * h + 1] * s1;
      float* p = out + (size_t)m * N + n;
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (n + 1 < N) p[1] = v1;
      }
    }
  }
}

}  // namespace tc

template <bool PACKED, int XW, int CW>
cudaError_t launch_tc_as(const __nv_bfloat16* x, const uint8_t* codes, const float* scale,
                         float* dst, int M, int K, int N, int k_chunk, dim3 grid, int xw,
                         int cw, cudaStream_t stream) {
  constexpr int smem = tc::Smem<PACKED>::BYTES;
  static unsigned long long opted_in = 0;
  const cudaError_t err = opt_in_smem(tc::qmm_tc<PACKED, XW, CW>, smem, opted_in);
  if (err != cudaSuccess) return err;
  tc::qmm_tc<PACKED, XW, CW><<<grid, tc::kThreads, smem, stream>>>(
      x, codes, scale, dst, M, K, N, k_chunk, xw, cw);
  return cudaGetLastError();
}

// 16-byte copies of both operands (the main paths) run an instance with
// the widths built in; any other alignment, the one that switches on them
template <bool PACKED>
cudaError_t launch_tc(const __nv_bfloat16* x, const uint8_t* codes, const float* scale,
                      float* dst, int M, int K, int N, int k_chunk, dim3 grid,
                      cudaStream_t stream) {
  const int xw = widest(x, 2LL * K, 16), cw = widest(codes, PACKED ? N / 2 : N, 16);
  if (xw == 16 && cw == 16)
    return launch_tc_as<PACKED, 16, 16>(x, codes, scale, dst, M, K, N, k_chunk, grid, xw,
                                        cw, stream);
  return launch_tc_as<PACKED, 0, 0>(x, codes, scale, dst, M, K, N, k_chunk, grid, xw, cw,
                                    stream);
}

template <typename XT, bool PACKED>
cudaError_t launch_simt(const XT* x, const uint8_t* codes, const float* scale, float* dst,
                        int M, int K, int N, int k_chunk, dim3 grid, cudaStream_t stream) {
  const int vec = PACKED ? 8 : 16;
  const int vec_ok = widest(codes, PACKED ? N / 2 : N, vec) == vec;
  simt::qmm_simt<XT, PACKED><<<grid, simt::kThreads, 0, stream>>>(
      x, codes, scale, dst, M, K, N, k_chunk, vec_ok);
  return cudaGetLastError();
}

// The product's partials into dst ((splits, M, N) f32, or y itself with
// one split) on the caller's core and K split (kernels/qmm.py · plan): K
// in `splits` slices of k_chunk rows, each a grid layer of the core's
// output tiles (tensor cores: (M tiles, N tiles); SIMT: (N tiles, M
// tiles)). A split that leaves K uncovered or a slice empty is refused
// (cudaErrorInvalidValue), as is the tensor-core core for f32 x or a
// k_chunk that is not a whole number of its K steps.
inline cudaError_t launch_product(int core, int x_bf16, const void* x, const uint8_t* codes,
                                  int packed, const float* scale, float* dst, int M, int K,
                                  int N, int splits, int k_chunk, cudaStream_t stream) {
  if (k_chunk < 1 || splits < 1 || (long long)splits * k_chunk < K ||
      (long long)(splits - 1) * k_chunk >= K)
    return cudaErrorInvalidValue;
  if (core == kCoreTc) {
    if (!x_bf16 || k_chunk % tc::BK) return cudaErrorInvalidValue;
    const dim3 grid((M + tc::BM - 1) / tc::BM, (N + tc::BN - 1) / tc::BN, splits);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    return packed ? launch_tc<true>(xb, codes, scale, dst, M, K, N, k_chunk, grid, stream)
                  : launch_tc<false>(xb, codes, scale, dst, M, K, N, k_chunk, grid, stream);
  }
  if (core != kCoreSimt) return cudaErrorInvalidValue;
  const dim3 grid((N + simt::BN - 1) / simt::BN, (M + simt::BM - 1) / simt::BM, splits);
  if (x_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    return packed ? launch_simt<__nv_bfloat16, true>(xb, codes, scale, dst, M, K, N, k_chunk,
                                                     grid, stream)
                  : launch_simt<__nv_bfloat16, false>(xb, codes, scale, dst, M, K, N,
                                                      k_chunk, grid, stream);
  }
  const float* xf = static_cast<const float*>(x);
  return packed ? launch_simt<float, true>(xf, codes, scale, dst, M, K, N, k_chunk, grid,
                                           stream)
                : launch_simt<float, false>(xf, codes, scale, dst, M, K, N, k_chunk, grid,
                                            stream);
}

__global__ void splitk_reduce(const float* __restrict__ part, float* __restrict__ out,
                              int splits, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(long long)z * mn + i];
  out[i] = s;
}

}  // namespace
