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
// Pass 1 writes, per block of kRowsPerBlock rows, the column absmaxes of the
// new m and √v; the host reduces those (a max, exact in any order) to the
// new scales s = absmax / qmax (0 → 1). Pass 2 recomputes m and v, writes the
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
// on such data). The design is
// coalesced streaming: in pass 1 a thread owns one column and walks its rows
// (consecutive threads on consecutive columns); pass 2 is a grid-stride loop
// in which a thread takes four consecutive elements at a time where C is a
// multiple of 4 and the operands are 16-byte aligned (16-byte loads of
// master, g and rand, 4-byte loads of the code planes, their codes decoded
// and packed by byte permutes, no I2F or F2I), so four hashes and four
// updates are in flight per thread, and one element at a time otherwise;
// the column is advanced without a division in the loop. The per-column
// scales stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 256;

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

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ g, const int8_t* __restrict__ mc,
              const float* __restrict__ ms, const int8_t* __restrict__ vc,
              const float* __restrict__ vs, const float* __restrict__ par,
              float* __restrict__ mx, float* __restrict__ vx, long long R,
              long long C, Consts k) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float clip = par[P_CLIP];
  const bool ok = par[P_FINITE] > 0.f;
  const float msc = ms[c], vsc = vs[c];
  const long long r0 = (long long)blockIdx.y * kRowsPerBlock;
  const long long r1 = min(R, r0 + kRowsPerBlock);
  float am = 0.f, av = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const long long i = r * C + c;
    float m, v;
    moments(g[i], static_cast<float>(mc[i]), msc, static_cast<float>(vc[i]), vsc, clip,
            ok, k, m, v);
    am = fmaxf(am, fabsf(m));
    av = fmaxf(av, __fsqrt_rn(v));
  }
  mx[blockIdx.y * C + c] = am;
  vx[blockIdx.y * C + c] = av;
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

// Pass 1: mx, vx (ceil(R / 256), C) f32 column absmaxes of the new m and
// √v per block of 256 rows. g (R, C) f32; mc, vc (R, C) int8; ms, vs (C)
// f32; par the device array [clip, finite, lr, b1c, b2c]. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int qadamw_absmax_launch(const void* g, const void* mc, const void* ms,
                                    const void* vc, const void* vs, const void* par,
                                    void* mx, void* vx, long long R, long long C,
                                    float b1, float omb1, float b2, float omb2,
                                    void* stream) {
  const Consts k{b1, omb1, b2, omb2, 0.f, 0.f, 0.f, 0.f};
  dim3 grid((unsigned)((C + kThreads - 1) / kThreads),
            (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock));
  absmax_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int8_t*>(mc),
      static_cast<const float*>(ms), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const float*>(par),
      static_cast<float*>(mx), static_cast<float*>(vx), R, C, k);
  return cudaGetLastError();
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
