// quant_adamw — the fused quantized-moment AdamW leaf update, in two passes.
//
// Replaces: src/repro/kernels/quant_adamw.py · qadamw_absmax (pass 1,
// _absmax_kernel) and qadamw_update (pass 2, _update_kernel), the Pallas
// TPU kernels behind registry.quant_adamw_update on the training path.
//
// Per element of a (R, C) leaf (a stacked weight flattened to rows), with
// the old moments stored as int8 codes and per-column f32 scales (v in the
// √v domain):
//   g' = g · clip;  m_prev = mc · ms;  v_prev = (vc · vs)²
//   m = b1 · m_prev + (1 − b1) · g';  v = b2 · v_prev + ((1 − b2) · g') · g'
//   (m, v) = finite ? (m, v) : (m_prev, v_prev)
//   update = clamp((m / b1c) / (√(v / b2c) + eps), ±uclip)
//   master' = finite ? master − lr · (update + wd · master) : master
// Pass 1 reduces the column absmaxes of the new m and √v; the new scales
// are s = absmax / qmax (0 → 1, an IEEE division). It has two entries on one
// body: the parity entry writes the Pallas kernel's partials, one row of
// column absmaxes per block of 256 rows; the path entry (qadamw_scales)
// merges them in the same launch and writes the new scales, so pass 2
// follows it with nothing between. Pass 2 recomputes m and v, writes the
// new master and re-encodes both moments stochastically:
//   code = clip(⌊t⌋ + [u < t − ⌊t⌋], ±qmax), t = m / s_m (resp. √v / s_v),
// with u1 = (w >> 16) · 2⁻¹⁶ for m and u2 = (w & 0xFFFF) · 2⁻¹⁶ for √v
// from one uint32 word w per element. The fp32 moments never reach HBM.
// Pass 2 has two entries: the parity entry reads w from a rand plane (the
// Pallas kernel's operand and contract); the keyed entry hashes it in
// registers as bits_at(k1, k2, i) of csrc/threefry.cuh at the element's flat
// index i of the (R, C) view — for the leaf's own shape the same index, as
// reshape(-1, C) is row-major — so the words jax.random.bits(key, shape)
// holds, and no plane is made or read. The two entries run one body, so
// their masters and codes are bit-equal.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn): nvcc would otherwise contract the EMA's
// adds-of-products into FMAs, and the plain version
// (kernels/ref.quant_adamw_ref), one PyTorch op at a time, rounds each.
//
// What bounds it on an H100: pass 1 reads g (4 bytes), both code planes
// (1 + 1) against ~15 f32 operations: bytes. Pass 2 reads master (4), g (4)
// and both code planes (2) and writes master (4) and both code planes (2):
// 16 bytes per element (20 with the parity entry's rand), against ~40 f32
// operations (five IEEE divisions and two square roots among them) and, in
// the keyed entry, the hash's 73 32-bit integer operations, 41 of them on
// the integer ALU pipe alone — at 64 a clock per SM (compute capability 9.0)
// half as long as the bytes take; but with the divisions' and square roots'
// instruction sequences the issue of ~250 instructions an element is what
// bounds the keyed entry in practice (scripts/sass_mix.py). Those sequences
// branch to a slow subroutine for a zero operand, and a training step's
// moments are mostly 0: update_one sets the results of zero moments
// without dividing, bit-equal (scripts/qadamw_pass2_timing.py times pass 2
// on such data).
//
// Pass 1's design (quant_adamw.plan in kernels/quant_adamw.py picks the
// layout from the shape and the addresses; this file takes it unchanged):
// a block of 8 warps owns a tile of 32 · W columns over a run of `rows`
// rows; a lane owns W consecutive columns (W 4 where C % 4 == 0 and g is
// 16-byte, the code planes 4-byte aligned: one 16-byte load of g and two
// 4-byte code loads a row, the codes decoded by byte permutes as pass 2's
// vector path does; else W 1), and each warp walks every 8th row of the
// run, issuing U rows' loads before its first max. The 8 warps' maxima
// meet once in shared memory. The path entry sizes the runs so that every
// leaf of the training path has at least 4 blocks per SM where its shape
// allows; each block folds its maxima into a kept workspace by atomicMax
// on their bits (the values folded are magnitudes with the sign bit clear,
// so their bits order as they do, a NaN above +inf), and the last block
// of a column tile to arrive (an arrival counter after __threadfence, as
// csrc/qmv.cu's merge) takes the tile's maxima with atomicExch, leaving 0,
// and writes the scales: the counters and the workspace, zeroed once when
// allocated, are 0 between calls, so no launch needs a memset. A max is
// exact in any order and nan_max keeps a NaN (as jnp.max does), so both
// entries are bit-equal to the plain versions whatever the split. Pass 2 is
// a grid-stride loop in which a thread takes four consecutive elements at
// a time where C is a multiple of 4 and the operands are 16-byte aligned
// (16-byte loads of master, g and rand, 4-byte loads of the code planes,
// their codes decoded and packed by byte permutes, no I2F or F2I), so four
// hashes and four updates are in flight per thread, and one element at a
// time otherwise; the column is advanced without a division in the loop.
// The per-column scales stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the step's traced scalars, one device array (the Pallas kernel's SMEM
// operand): they come out of the gradient norm, so they never visit the host
enum { P_CLIP = 0, P_FINITE = 1, P_LR = 2, P_B1C = 3, P_B2C = 4 };

struct Consts {
  float b1, omb1, b2, omb2, eps, wd, qmax, uclip;
};

// the new m and v of one element from its old codes (as floats) and scales
__device__ __forceinline__ void moments(float g, float mc, float ms, float vc, float vs,
                                        float clip, bool ok, const Consts& k, float& m_store,
                                        float& v_store) {
  const float g32 = __fmul_rn(g, clip);
  const float m_prev = __fmul_rn(mc, ms);
  const float v_sqrt = __fmul_rn(vc, vs);
  const float v_prev = __fmul_rn(v_sqrt, v_sqrt);
  const float m = __fadd_rn(__fmul_rn(k.b1, m_prev), __fmul_rn(k.omb1, g32));
  const float v = __fadd_rn(__fmul_rn(k.b2, v_prev),
                            __fmul_rn(__fmul_rn(k.omb2, g32), g32));
  m_store = ok ? m : m_prev;
  v_store = ok ? v : v_prev;
}

// the stochastic code of t as a float holding an integer in [−qmax, qmax]
__device__ __forceinline__ float stoch_code(float t, float u, float qmax) {
  const float lo = floorf(t);
  const float c = lo + (u < __fsub_rn(t, lo) ? 1.f : 0.f);
  return fminf(fmaxf(c, -qmax), qmax);
}

// an integer-valued float c, |c| < 2²², as its two's-complement low byte:
// 1.5 · 2²³ + c is exact and holds c in its low mantissa bits (no F2I)
__device__ __forceinline__ uint32_t code_byte(float c) {
  return __float_as_uint(__fadd_rn(c, 12582912.f)) & 0xFFu;
}

// the 16-bit halves of w as floats in [0, 1): exactly (w >> 16) · 2⁻¹⁶ and
// (w & 0xFFFF) · 2⁻¹⁶, built bit-wise (2²³ + h, less 2²³; no I2F)
__device__ __forceinline__ void rand_halves(uint32_t w, float& u1, float& u2) {
  u1 = (__uint_as_float(0x4B000000u | (w >> 16)) - 8388608.f) * (1.f / 65536.f);
  u2 = (__uint_as_float(0x4B000000u | (w & 0xFFFFu)) - 8388608.f) * (1.f / 65536.f);
}

// pass 1's operands and layout (quant_adamw.plan)
struct AbsmaxArgs {
  const float* g;
  const int8_t* mc;
  const float* ms;
  const int8_t* vc;
  const float* vs;
  const float* par;
  float* out_m;           // partials: (runs, C) column absmaxes; else (C,) new scales
  float* out_v;
  unsigned int* ws;       // scales over runs > 1: (2, C) maxima as f32 bits, 0 between calls
  int* counters;          // scales over runs > 1: one a column tile, 0 between calls
  long long R, C;
  int rows, runs;         // rows a block; blocks along R (gridDim.y)
  int partials;           // 1: the parity entry (partials, no merge)
  Consts k;
};

// a new scale from a column's absmax: absmax / qmax, 0 → 1, NaN stays NaN
__device__ __forceinline__ float scale_of(float absmax, float qmax) {
  return absmax == 0.f ? 1.f : __fdiv_rn(absmax, qmax);
}

// fold one element's new |m| and √v into its column's maxima (fabsf also
// clears a NaN's sign bit)
__device__ __forceinline__ void fold(float g, float mc, float ms, float vc, float vs,
                                     float clip, bool ok, const Consts& k, float& am,
                                     float& av) {
  float m, v;
  moments(g, mc, ms, vc, vs, clip, ok, k, m, v);
  am = nan_max(am, fabsf(m));
  av = nan_max(av, fabsf(__fsqrt_rn(v)));
}

// block (tile, run): columns [tile · 32W, +32W) over rows [run · rows, +rows)
template <int W, int U>
__global__ void __launch_bounds__(kThreads) absmax_kernel(const AbsmaxArgs a) {
  constexpr int kTile = 32 * W;
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * kTile + lane * W;
  const long long r0 = (long long)blockIdx.y * a.rows;
  const long long r1 = min(a.R, r0 + a.rows);
  const bool live = c0 < a.C;  // W 4 takes C % 4 == 0: all four columns are
  const float clip = a.par[P_CLIP];
  const bool ok = a.par[P_FINITE] > 0.f;
  float msc[W], vsc[W], am[W], av[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    msc[w] = live ? a.ms[c0 + w] : 0.f;
    vsc[w] = live ? a.vs[c0 + w] : 0.f;
    am[w] = av[w] = 0.f;
  }
  for (long long r = r0 + wy; live && r < r1; r += kWarps * U) {
    if constexpr (W == 4) {
      float4 gq[U];
      uint32_t mq[U], vq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {   // every load of the U rows first
        const long long i = (r + u * kWarps) * a.C + c0;
        const bool in = r + u * kWarps < r1;
        gq[u] = in ? __ldg(reinterpret_cast<const float4*>(a.g + i))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        mq[u] = in ? __ldg(reinterpret_cast<const unsigned int*>(a.mc + i)) ^ 0x80808080u : 0u;
        vq[u] = in ? __ldg(reinterpret_cast<const unsigned int*>(a.vc + i)) ^ 0x80808080u : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * kWarps >= r1) break;
        fold(gq[u].x, int8_at<0>(mq[u]), msc[0], int8_at<0>(vq[u]), vsc[0], clip, ok, a.k,
             am[0], av[0]);
        fold(gq[u].y, int8_at<1>(mq[u]), msc[1], int8_at<1>(vq[u]), vsc[1], clip, ok, a.k,
             am[1], av[1]);
        fold(gq[u].z, int8_at<2>(mq[u]), msc[2], int8_at<2>(vq[u]), vsc[2], clip, ok, a.k,
             am[2], av[2]);
        fold(gq[u].w, int8_at<3>(mq[u]), msc[3], int8_at<3>(vq[u]), vsc[3], clip, ok, a.k,
             am[3], av[3]);
      }
    } else {
      float gq[U];
      int8_t mq[U], vq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = (r + u * kWarps) * a.C + c0;
        const bool in = r + u * kWarps < r1;
        gq[u] = in ? __ldg(a.g + i) : 0.f;
        mq[u] = in ? __ldg(a.mc + i) : int8_t(0);
        vq[u] = in ? __ldg(a.vc + i) : int8_t(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * kWarps >= r1) break;
        fold(gq[u], int8_at<0>(static_cast<uint8_t>(mq[u]) ^ 0x80u), msc[0],
             int8_at<0>(static_cast<uint8_t>(vq[u]) ^ 0x80u), vsc[0], clip, ok, a.k, am[0],
             av[0]);
      }
    }
  }
  // the 8 warps' maxima meet once; thread (arr, col) takes column col of
  // m (arr 0) or √v (arr 1)
  __shared__ float red[2][kWarps][kTile];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    red[0][wy][lane * W + w] = am[w];
    red[1][wy][lane * W + w] = av[w];
  }
  __syncthreads();
  const int arr = threadIdx.x / kTile, col = threadIdx.x % kTile;
  const long long c = (long long)blockIdx.x * kTile + col;
  const bool mine = arr < 2 && c < a.C;
  float best = 0.f;
  if (mine) {
    best = red[arr][0][col];
#pragma unroll
    for (int y = 1; y < kWarps; ++y) best = nan_max(best, red[arr][y][col]);
  }
  float* out = arr == 0 ? a.out_m : a.out_v;
  if (a.partials) {
    if (mine) out[(long long)blockIdx.y * a.C + c] = best;
    return;
  }
  if (a.runs == 1) {
    if (mine) out[c] = scale_of(best, a.k.qmax);
    return;
  }
  unsigned int* slot = a.ws + (mine ? arr * a.C + c : 0);
  if (mine && __float_as_uint(best) != 0u) atomicMax(slot, __float_as_uint(best));
  if (!last_to_arrive(a.counters, blockIdx.x, a.runs)) return;
  if (mine) out[c] = scale_of(__uint_as_float(atomicExch(slot, 0u)), a.k.qmax);
}

template <int W>
cudaError_t launch_absmax(int unroll, dim3 grid, const AbsmaxArgs& a, cudaStream_t st) {
  switch (unroll) {
    case 4: absmax_kernel<W, 4><<<grid, kThreads, 0, st>>>(a); break;
    case 8: absmax_kernel<W, 8><<<grid, kThreads, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the step's traced scalars of pass 2, read once per thread
struct Step {
  float clip, lr, b1c, b2c;
  bool ok;
  bool pos;  // b1c, b2c and eps all > 0
};

// one element of pass 2: the new master, and both codes as bytes (mb, vb);
// mc, vc the old codes as floats. IEEE division and square root branch to
// a slow subroutine for a zero operand, and on training data most moments
// of a step are 0 (a leaf's untouched rows, codes rounded to 0): where m
// and v are both ±0 and every divisor is positive, each quotient and root
// below is its own ±0 dividend, so that branch sets them without dividing
// (bit-equal); every other element takes the divisions
__device__ __forceinline__ float update_one(float mst, float g, float mc, float ms, float vc,
                                            float vs, float msn, float vsn, uint32_t w,
                                            const Step& p, const Consts& k, uint32_t& mb,
                                            uint32_t& vb) {
  float m, v;
  moments(g, mc, ms, vc, vs, p.clip, p.ok, k, m, v);
  float update, tm, tv;
  if (m == 0.f && v == 0.f && p.pos && msn > 0.f && vsn > 0.f) {
    update = m;
    tm = m;
    tv = v;
  } else {
    update = __fdiv_rn(__fdiv_rn(m, p.b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, p.b2c)), k.eps));
    tm = __fdiv_rn(m, msn);
    tv = __fdiv_rn(__fsqrt_rn(v), vsn);
  }
  if (k.uclip > 0.f) update = fminf(fmaxf(update, -k.uclip), k.uclip);
  float u1, u2;
  rand_halves(w, u1, u2);
  mb = code_byte(stoch_code(tm, u1, k.qmax));
  vb = code_byte(stoch_code(tv, u2, k.qmax));
  return p.ok ? __fsub_rn(mst, __fmul_rn(p.lr, __fadd_rn(update, __fmul_rn(k.wd, mst))))
              : mst;
}

// four code bytes (each in the low byte of its word) as one word
__device__ __forceinline__ uint32_t pack4(const uint32_t b[4]) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                     0x5410);
}

// KEYED: the words come from bits_at(k1, k2, i), else from rand[i]. VEC: a
// thread takes 4 consecutive elements (C % 4 == 0, aligned planes), else 1.
template <bool KEYED, bool VEC>
__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ master, const float* __restrict__ g,
              const int8_t* __restrict__ mc, const float* __restrict__ ms,
              const int8_t* __restrict__ vc, const float* __restrict__ vs,
              const float* __restrict__ msn, const float* __restrict__ vsn,
              const uint32_t* __restrict__ rand, uint32_t k1, uint32_t k2,
              const float* __restrict__ par, float* __restrict__ out_master,
              int8_t* __restrict__ out_mc, int8_t* __restrict__ out_vc, long long R,
              long long C, Consts k) {
  constexpr int W = VEC ? 4 : 1;  // elements a thread takes per turn
  const Step p{par[P_CLIP], par[P_LR], par[P_B1C], par[P_B2C], par[P_FINITE] > 0.f,
               par[P_B1C] > 0.f && par[P_B2C] > 0.f && k.eps > 0.f};
  const long long groups = R * C / W;
  const long long step = (long long)gridDim.x * kThreads;
  long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= groups) return;
  // the column of the group's first element, advanced by dc with q
  const long long dc = (step * W) % C;
  long long c = (q * W) % C;
  for (; q < groups; q += step) {
    const long long i = q * W;
    if constexpr (VEC) {
      const float4 m4 = *reinterpret_cast<const float4*>(master + i);
      const float4 g4 = *reinterpret_cast<const float4*>(g + i);
      const uint32_t mw = *reinterpret_cast<const uint32_t*>(mc + i) ^ 0x80808080u;
      const uint32_t vw = *reinterpret_cast<const uint32_t*>(vc + i) ^ 0x80808080u;
      const float4 ms4 = *reinterpret_cast<const float4*>(ms + c);
      const float4 vs4 = *reinterpret_cast<const float4*>(vs + c);
      const float4 msn4 = *reinterpret_cast<const float4*>(msn + c);
      const float4 vsn4 = *reinterpret_cast<const float4*>(vsn + c);
      uint32_t w[4];
      if constexpr (KEYED) {
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = bits_at(k1, k2, static_cast<unsigned long long>(i + e));
      } else {
        const uint4 r4 = *reinterpret_cast<const uint4*>(rand + i);
        w[0] = r4.x, w[1] = r4.y, w[2] = r4.z, w[3] = r4.w;
      }
      uint32_t mb[4], vb[4];
      float4 o;
      o.x = update_one(m4.x, g4.x, int8_at<0>(mw), ms4.x, int8_at<0>(vw), vs4.x, msn4.x,
                       vsn4.x, w[0], p, k, mb[0], vb[0]);
      o.y = update_one(m4.y, g4.y, int8_at<1>(mw), ms4.y, int8_at<1>(vw), vs4.y, msn4.y,
                       vsn4.y, w[1], p, k, mb[1], vb[1]);
      o.z = update_one(m4.z, g4.z, int8_at<2>(mw), ms4.z, int8_at<2>(vw), vs4.z, msn4.z,
                       vsn4.z, w[2], p, k, mb[2], vb[2]);
      o.w = update_one(m4.w, g4.w, int8_at<3>(mw), ms4.w, int8_at<3>(vw), vs4.w, msn4.w,
                       vsn4.w, w[3], p, k, mb[3], vb[3]);
      *reinterpret_cast<float4*>(out_master + i) = o;
      *reinterpret_cast<uint32_t*>(out_mc + i) = pack4(mb);
      *reinterpret_cast<uint32_t*>(out_vc + i) = pack4(vb);
    } else {
      uint32_t w;
      if constexpr (KEYED) {
        w = bits_at(k1, k2, static_cast<unsigned long long>(i));
      } else {
        w = rand[i];
      }
      uint32_t mb, vb;
      out_master[i] = update_one(master[i], g[i], static_cast<float>(mc[i]), ms[c],
                                 static_cast<float>(vc[i]), vs[c], msn[c], vsn[c], w, p, k,
                                 mb, vb);
      out_mc[i] = static_cast<int8_t>(mb);
      out_vc[i] = static_cast<int8_t>(vb);
    }
    c += dc;
    if (c >= C) c -= C;
  }
}

template <bool KEYED, bool VEC>
cudaError_t launch_update(const void* master, const void* g, const void* mc, const void* ms,
                          const void* vc, const void* vs, const void* msn, const void* vsn,
                          const void* rand, uint32_t k1, uint32_t k2, const void* par,
                          void* out_master, void* out_mc, void* out_vc, long long R,
                          long long C, const Consts& k, cudaStream_t stream) {
  const long long groups = R * C / (VEC ? 4 : 1);
  if (groups <= 0) return cudaSuccess;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  update_kernel<KEYED, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(master), static_cast<const float*>(g),
      static_cast<const int8_t*>(mc), static_cast<const float*>(ms),
      static_cast<const int8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const float*>(msn), static_cast<const float*>(vsn),
      static_cast<const uint32_t*>(rand), k1, k2, static_cast<const float*>(par),
      static_cast<float*>(out_master), static_cast<int8_t*>(out_mc),
      static_cast<int8_t*>(out_vc), R, C, k);
  return cudaGetLastError();
}

template <bool KEYED>
int dispatch_update(const void* master, const void* g, const void* mc, const void* ms,
                    const void* vc, const void* vs, const void* msn, const void* vsn,
                    const void* rand, uint32_t k1, uint32_t k2, const void* par,
                    void* out_master, void* out_mc, void* out_vc, long long R, long long C,
                    const Consts& k, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_update<KEYED, true>(master, g, mc, ms, vc, vs, msn, vsn, rand, k1, k2,
                                          par, out_master, out_mc, out_vc, R, C, k, st)
             : launch_update<KEYED, false>(master, g, mc, ms, vc, vs, msn, vsn, rand, k1, k2,
                                           par, out_master, out_mc, out_vc, R, C, k, st);
}

}  // namespace

// Pass 1, both entries, as quant_adamw.plan laid it out: a block per
// column tile of 32 · width columns (tiles of them) and run of `rows` rows
// (runs of them), each warp issuing `unroll` rows' loads before its first
// max. g (R, C) f32; mc, vc (R, C) int8; ms, vs (C) f32; par the device
// array [clip, finite, lr, b1c, b2c]. partials = 1 (the parity entry):
// out_m, out_v (runs, C) f32, each run's column absmaxes of the new m and
// √v. partials = 0: out_m, out_v (C) f32 the new scales absmax / qmax (0 →
// 1), merged in the launch through ws (2, C) uint32 and counters (tiles)
// int32, both 0, when runs > 1. width 4 promises C % 4 == 0, g 16-byte and
// the code planes 4-byte aligned. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int qadamw_absmax_launch(const void* g, const void* mc, const void* ms,
                                    const void* vc, const void* vs, const void* par,
                                    void* out_m, void* out_v, void* ws, void* counters,
                                    long long R, long long C, float b1, float omb1, float b2,
                                    float omb2, float qmax, int width, int unroll, int rows,
                                    long long tiles, int runs, int partials, void* stream) {
  if (R < 1 || C < 1 || rows < 1 || runs < 1 || runs > 65535 || tiles < 1 ||
      tiles > 2147483647LL || tiles * 32 * width < C || (long long)runs * rows < R ||
      (long long)(runs - 1) * rows >= R || (width == 4 && C % 4) ||
      (!partials && runs > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  AbsmaxArgs a{static_cast<const float*>(g), static_cast<const int8_t*>(mc),
               static_cast<const float*>(ms), static_cast<const int8_t*>(vc),
               static_cast<const float*>(vs), static_cast<const float*>(par),
               static_cast<float*>(out_m), static_cast<float*>(out_v),
               static_cast<unsigned int*>(ws), static_cast<int*>(counters), R, C, rows, runs,
               partials, Consts{b1, omb1, b2, omb2, 0.f, 0.f, qmax, 0.f}};
  const dim3 grid((unsigned)tiles, (unsigned)runs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch_absmax<1>(unroll, grid, a, st);
    case 4: return launch_absmax<4>(unroll, grid, a, st);
  }
  return cudaErrorInvalidValue;
}

// Pass 2: the new master (R, C) f32 and both moment code planes (R, C) int8
// against the new scales msn, vsn (C) f32, from rand (R, C) uint32. vec = 1
// promises C % 4 == 0, the f32 planes, rand and every scale 16-byte aligned
// and the code planes 4-byte aligned. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int qadamw_update_launch(const void* master, const void* g, const void* mc,
                                    const void* ms, const void* vc, const void* vs,
                                    const void* msn, const void* vsn, const void* rand,
                                    const void* par, void* out_master, void* out_mc,
                                    void* out_vc, long long R, long long C, float b1,
                                    float omb1, float b2, float omb2, float eps,
                                    float wd, float qmax, float uclip, int vec,
                                    void* stream) {
  const Consts k{b1, omb1, b2, omb2, eps, wd, qmax, uclip};
  return dispatch_update<false>(master, g, mc, ms, vc, vs, msn, vsn, rand, 0u, 0u, par,
                                out_master, out_mc, out_vc, R, C, k, vec, stream);
}

// Pass 2, keyed: as qadamw_update_launch, with the word of element i hashed
// from the key (k1, k2) at counter i (jax.random.bits(key, (R, C))[i]).
extern "C" int qadamw_update_keyed_launch(const void* master, const void* g, const void* mc,
                                          const void* ms, const void* vc, const void* vs,
                                          const void* msn, const void* vsn, unsigned int k1,
                                          unsigned int k2, const void* par, void* out_master,
                                          void* out_mc, void* out_vc, long long R,
                                          long long C, float b1, float omb1, float b2,
                                          float omb2, float eps, float wd, float qmax,
                                          float uclip, int vec, void* stream) {
  const Consts k{b1, omb1, b2, omb2, eps, wd, qmax, uclip};
  return dispatch_update<true>(master, g, mc, ms, vc, vs, msn, vsn, nullptr, k1, k2, par,
                               out_master, out_mc, out_vc, R, C, k, vec, stream);
}

extern "C" const char* quant_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
