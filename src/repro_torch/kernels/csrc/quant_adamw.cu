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
// with u1 = (rand >> 16) · 2⁻¹⁶ for m and u2 = (rand & 0xFFFF) · 2⁻¹⁶ for √v
// from one uint32 word per element. The fp32 moments never reach HBM.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn): nvcc would otherwise contract the EMA's
// adds-of-products into FMAs, and the plain version
// (kernels/ref.quant_adamw_ref), one PyTorch op at a time, rounds each.
//
// What bounds it on an H100: bytes. Pass 1 reads g (4), both code planes
// (1 + 1); pass 2 reads master (4), g (4), both code planes (2) and rand (4)
// and writes master (4) and both code planes (2): 26 bytes per element
// against ~40 f32 operations — two orders of magnitude below the card's
// balance point. The design is coalesced streaming: in pass 1 a thread owns
// one column and walks its rows (consecutive threads on consecutive
// columns); pass 2 is a grid-stride elementwise loop. The per-column scales
// stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 256;

// the step's traced scalars, one device array (the Pallas kernel's SMEM
// operand): they come out of the gradient norm, so they never visit the host
enum { P_CLIP = 0, P_FINITE = 1, P_LR = 2, P_B1C = 3, P_B2C = 4 };

struct Consts {
  float b1, omb1, b2, omb2, eps, wd, qmax, uclip;
};

__device__ __forceinline__ void moments(float g, int8_t mc, float ms, int8_t vc,
                                        float vs, float clip, bool ok,
                                        const Consts& k, float& m_store,
                                        float& v_store) {
  const float g32 = __fmul_rn(g, clip);
  const float m_prev = __fmul_rn(static_cast<float>(mc), ms);
  const float v_sqrt = __fmul_rn(static_cast<float>(vc), vs);
  const float v_prev = __fmul_rn(v_sqrt, v_sqrt);
  const float m = __fadd_rn(__fmul_rn(k.b1, m_prev), __fmul_rn(k.omb1, g32));
  const float v = __fadd_rn(__fmul_rn(k.b2, v_prev),
                            __fmul_rn(__fmul_rn(k.omb2, g32), g32));
  m_store = ok ? m : m_prev;
  v_store = ok ? v : v_prev;
}

__device__ __forceinline__ int8_t stoch_code(float t, float u, float qmax) {
  const float lo = floorf(t);
  float c = lo + (u < __fsub_rn(t, lo) ? 1.f : 0.f);
  c = fminf(fmaxf(c, -qmax), qmax);
  return static_cast<int8_t>(static_cast<int>(c));
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
    moments(g[i], mc[i], msc, vc[i], vsc, clip, ok, k, m, v);
    am = fmaxf(am, fabsf(m));
    av = fmaxf(av, __fsqrt_rn(v));
  }
  mx[blockIdx.y * C + c] = am;
  vx[blockIdx.y * C + c] = av;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const float* __restrict__ master, const float* __restrict__ g,
              const int8_t* __restrict__ mc, const float* __restrict__ ms,
              const int8_t* __restrict__ vc, const float* __restrict__ vs,
              const float* __restrict__ msn, const float* __restrict__ vsn,
              const uint32_t* __restrict__ rand, const float* __restrict__ par,
              float* __restrict__ out_master, int8_t* __restrict__ out_mc,
              int8_t* __restrict__ out_vc, long long R, long long C, Consts k) {
  const float clip = par[P_CLIP];
  const bool ok = par[P_FINITE] > 0.f;
  const float lr = par[P_LR], b1c = par[P_B1C], b2c = par[P_B2C];
  const long long n = R * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long c = i % C;
    float m, v;
    moments(g[i], mc[i], ms[c], vc[i], vs[c], clip, ok, k, m, v);
    float update = __fdiv_rn(__fdiv_rn(m, b1c),
                             __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), k.eps));
    if (k.uclip > 0.f) update = fminf(fmaxf(update, -k.uclip), k.uclip);
    const float mst = master[i];
    out_master[i] = ok ? __fsub_rn(mst, __fmul_rn(lr, __fadd_rn(update, __fmul_rn(k.wd, mst))))
                       : mst;
    const uint32_t u = rand[i];
    const float u1 = static_cast<float>(u >> 16) * (1.f / 65536.f);
    const float u2 = static_cast<float>(u & 0xFFFFu) * (1.f / 65536.f);
    out_mc[i] = stoch_code(__fdiv_rn(m, msn[c]), u1, k.qmax);
    out_vc[i] = stoch_code(__fdiv_rn(__fsqrt_rn(v), vsn[c]), u2, k.qmax);
  }
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
// against the new scales msn, vsn (C) f32, from rand (R, C) uint32. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int qadamw_update_launch(const void* master, const void* g, const void* mc,
                                    const void* ms, const void* vc, const void* vs,
                                    const void* msn, const void* vsn, const void* rand,
                                    const void* par, void* out_master, void* out_mc,
                                    void* out_vc, long long R, long long C, float b1,
                                    float omb1, float b2, float omb2, float eps,
                                    float wd, float qmax, float uclip, void* stream) {
  const Consts k{b1, omb1, b2, omb2, eps, wd, qmax, uclip};
  const long long n = R * C;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
  if (blocks < 1) blocks = 1;
  update_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(master), static_cast<const float*>(g),
      static_cast<const int8_t*>(mc), static_cast<const float*>(ms),
      static_cast<const int8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const float*>(msn), static_cast<const float*>(vsn),
      static_cast<const uint32_t*>(rand), static_cast<const float*>(par),
      static_cast<float*>(out_master), static_cast<int8_t*>(out_mc),
      static_cast<int8_t*>(out_vc), R, C, k);
  return cudaGetLastError();
}

extern "C" const char* quant_adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
