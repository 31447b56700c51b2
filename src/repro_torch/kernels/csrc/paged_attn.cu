// paged_decode_attn — one-token GQA flash decode over a paged KV pool whose
// pages hold bf16 rows, int8 codes or nibble-packed int4 codes.
//
// Replaces: src/repro/kernels/paged_attn.py · paged_decode_attn
// (_paged_attn_kernel), the Pallas TPU decode kernel of the serving engine.
//
// Computes, per sequence b and query head h = g·R + r (R = H / Hkv):
//   out[b, h] = softmax_t(q·k_t · softmax_scale, masked at t ≥ seq_len[b]) · v
// over the rows t of the pages block_table[b, 0..], dequantized in f32
// (code · scale per (token, head)); masking uses the finite NEG_INF = −2³⁰
// of models/attention.py, and a sequence of length 0 outputs 0.
//
// What bounds it on an H100: the bytes of the KV rows a sequence actually
// holds (one byte per element at int8, half at int4) plus per-launch
// latency — the arithmetic is 4·H·D operations per token, a few per byte.
//
// What the design does about it: one block per (sequence, kv head) reads
// its own block-table row and seq_len (this replaces the TPU's scalar
// prefetch) and walks only the ceil(len / page) pages that hold rows — a
// fully masked page would add exactly 0 (alpha = 1, p = 0), so stopping
// early changes nothing. Each page is loaded once, dequantized into shared
// memory (int4 unpacked in registers), and shared by all R query heads of
// the group: K/V bytes are read once per group, never once per head. The
// online softmax keeps its running max / denominator / weighted values in
// f32 in shared memory, with the explicit re-mask of paged_attn.py:115-117.
// Splitting a long sequence over several blocks (flash-decoding) is later
// work; at the serving engine's lengths the launch dominates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1073741824.0f;  // −2³⁰: finite, exp() == 0 in f32

template <int KV_BITS>
__device__ __forceinline__ float load_kv(const void* pages, const float* scale,
                                         long long row, int D, int d) {
  if (KV_BITS == 0)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pages)[row * D + d]);
  if (KV_BITS == 8)
    return static_cast<float>(static_cast<const int8_t*>(pages)[row * D + d]) * scale[row];
  const uint32_t b = static_cast<const uint8_t*>(pages)[row * (D / 2) + (d >> 1)];
  const int nib = static_cast<int>((b >> (4 * (d & 1))) & 0xFu);
  return (static_cast<float>(nib) - 8.0f) * scale[row];
}

template <int KV_BITS, bool Q_BF16>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const void* __restrict__ q, const void* __restrict__ k_pages,
                  const void* __restrict__ v_pages, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ block_table,
                  const int* __restrict__ seq_lens, float* __restrict__ out,
                  int H, int Hkv, int D, int page, int maxp, float softmax_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int R = H / Hkv;
  float* qs = smem;                 // (R, D)
  float* ks = qs + R * D;           // (page, D)
  float* vs = ks + page * D;        // (page, D)
  float* acc = vs + page * D;       // (R, D)
  float* sp = acc + R * D;          // (R, page): scores, then probabilities
  float* m_run = sp + R * page;     // (R,)
  float* l_run = m_run + R;         // (R,)
  float* alpha = l_run + R;         // (R,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = kThreads / 32;
  const int len = seq_lens[b];
  const int n_used = min(maxp, (len + page - 1) / page);
  const long long q_off = ((long long)b * H + (long long)g * R) * D;

  for (int i = tid; i < R * D; i += kThreads) {
    qs[i] = Q_BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[q_off + i])
                   : static_cast<const float*>(q)[q_off + i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }

  for (int p = 0; p < n_used; ++p) {
    const long long pid = block_table[(long long)b * maxp + p];
    __syncthreads();  // previous page fully consumed
    for (int i = tid; i < page * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const long long row = (pid * page + t) * Hkv + g;
      ks[i] = load_kv<KV_BITS>(k_pages, k_scale, row, D, d);
      vs[i] = load_kv<KV_BITS>(v_pages, v_scale, row, D, d);
    }
    __syncthreads();
    // scores: one warp per (head, token) pair, lanes split D
    for (int pr = warp; pr < R * page; pr += n_warps) {
      const int r = pr / page, t = pr % page;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(qs[r * D + d], ks[t * D + d], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) sp[pr] = (p * page + t < len) ? dot * softmax_scale : kNegInf;
    }
    __syncthreads();
    // online softmax, one thread per head
    for (int r = tid; r < R; r += kThreads) {
      const float m_prev = m_run[r];
      float mx = kNegInf;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sp[r * page + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        // explicit re-mask: on a fully masked page m_new stays NEG_INF and
        // exp(s − m_new) would be 1
        const float pe = (p * page + t < len) ? expf(sp[r * page + t] - m_new) : 0.f;
        sp[r * page + t] = pe;
        sum += pe;
      }
      const float a = expf(m_prev - m_new);
      l_run[r] = l_run[r] * a + sum;
      alpha[r] = a;
      m_run[r] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < page; ++t) a = fmaf(sp[r * page + t], vs[t * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    out[q_off + i] = acc[i] / fmaxf(l_run[r], 1e-30f);
  }
}

template <int KV_BITS, bool Q_BF16>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ksc,
                   const float* vsc, const int* bt, const int* lens, float* out,
                   int B, int H, int Hkv, int D, int page, int maxp,
                   float softmax_scale, cudaStream_t stream) {
  const int R = H / Hkv;
  const size_t smem = sizeof(float) * (size_t)(2 * R * D + 2 * page * D + R * page + 3 * R);
  auto kernel = paged_attn_kernel<KV_BITS, Q_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      q, kp, vp, ksc, vsc, bt, lens, out, H, Hkv, D, page, maxp, softmax_scale);
  return cudaGetLastError();
}

template <int KV_BITS>
cudaError_t launch_q(int q_bf16, const void* q, const void* kp, const void* vp,
                     const float* ksc, const float* vsc, const int* bt,
                     const int* lens, float* out, int B, int H, int Hkv, int D,
                     int page, int maxp, float softmax_scale, cudaStream_t s) {
  return q_bf16 ? launch<KV_BITS, true>(q, kp, vp, ksc, vsc, bt, lens, out, B, H, Hkv, D, page, maxp, softmax_scale, s)
                : launch<KV_BITS, false>(q, kp, vp, ksc, vsc, bt, lens, out, B, H, Hkv, D, page, maxp, softmax_scale, s);
}

}  // namespace

// out (B, H, D) f32. q (B, H, D) bf16 (q_bf16) or f32; pages (P, page, Hkv,
// D) bf16 (kv_bits 0) / int8 (8) or (P, page, Hkv, D/2) uint8 (4); scales
// (P, page, Hkv, 1) f32, unused at kv_bits 0; block_table (B, maxp) int32;
// seq_lens (B,) int32. Returns the cudaError_t of the launch.
extern "C" int paged_attn_launch(const void* q, int q_bf16, const void* k_pages,
                                 const void* v_pages, const float* k_scale,
                                 const float* v_scale, const int* block_table,
                                 const int* seq_lens, float* out, int B, int H,
                                 int Hkv, int D, int page, int maxp, int kv_bits,
                                 float softmax_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bits == 8)
    return launch_q<8>(q_bf16, q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens, out, B, H, Hkv, D, page, maxp, softmax_scale, s);
  if (kv_bits == 4)
    return launch_q<4>(q_bf16, q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens, out, B, H, Hkv, D, page, maxp, softmax_scale, s);
  return launch_q<0>(q_bf16, q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens, out, B, H, Hkv, D, page, maxp, softmax_scale, s);
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
