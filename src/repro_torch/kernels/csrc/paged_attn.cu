// paged_decode_attn — one-token GQA flash decode over a paged KV pool whose
// pages hold bf16 rows, int8 codes or nibble-packed int4 codes, split over
// the card by fixed runs of pages (flash decoding) and merged in fixed order.
//
// Replaces: src/repro/kernels/paged_attn.py · paged_decode_attn
// (_paged_attn_kernel), the Pallas TPU decode kernel of the serving engine.
//
// Computes, per sequence b and query head h = g·R + r (R = H / Hkv):
//   out[b, h] = softmax_t(q·k_t · softmax_scale, masked at t ≥ seq_len[b]) · v
// over the rows t of the pages block_table[b, 0..], dequantized in f32
// (code · scale per (token, head)); a sequence of length 0 outputs 0.
//
// What bounds it on an H100: at serving lengths neither the bytes (a few
// hundred KB a call: well under a microsecond at 3.35 TB/s) nor the
// arithmetic (4·H·D operations per token), but latency: the launch, the
// dependent reads seq_len → block table → pages from a cold L2, and the
// serial steps of the softmax. One block walking a whole sequence leaves
// most SMs idle and pays those round trips once per page.
//
// What the design does about it:
// - A block owns one (sequence b, kv head g, split s); a split is
//   kPagesPerSplit consecutive entries of the block table. The grid B × Hkv
//   × ceil(MAXP / kPagesPerSplit) comes from shapes alone; a block whose
//   split starts at or past ceil(seq_len / page) returns at once.
// - A block reads seq_len and its block-table entries together, then
//   issues every K and V row (and scale) of its split as cp.async copies —
//   16 bytes a copy where the row's bytes and base allow, else 8 or 4 —
//   reads q under them and waits once: two dependent round trips in all.
//   The K/V bytes of a kv head are read once for its R query heads.
// - Scores: one warp per token, lanes over D in chunks of 4 elements, every
//   query head of the group against one dequantized chunk; an int8/int4
//   row's scale multiplies its dot product. Softmax: one warp per head,
//   max and sum by shuffles. Rows at or past seq_len never enter a sum:
//   their probability is exactly 0.
// - A sequence of one split writes its output directly. Otherwise each
//   split writes (max, denominator, R × D weighted values) to a workspace,
//   and the last block of (b, g) to arrive — a per-(b, g) counter bumped by
//   atomicAdd after __threadfence, set back to 0 by that block — merges the
//   splits in order 0, 1, 2, … One launch per call; no memset.
// The order of every sum depends on the row's own seq_len, the page size,
// D, R and the constants here alone — not on B, MAXP, the other rows or
// the number of SMs — so a row computes the same bits in a decode step and
// inside a speculative verify window.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pages per split: of 1, 2 and 4, one is fastest at every serving length
// and head layout, 4 at rows of thousands of tokens, whose merge it
// shortens (scripts/paged_attn_split_sweep.py, PERF.md §6)
constexpr int kPagesPerSplit = 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;        // 4-element chunks per lane: D ≤ 512
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1073741824.0f;  // −2³⁰, the NEG_INF of models/attention.py

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline int row_bytes(int kv_bits, int D) {
  return kv_bits == 0 ? 2 * D : kv_bits == 8 ? D : D / 2;
}

// dynamic shared memory of one block, in bytes from its base: q (R, D) f32,
// the split's K and V rows as stored, their scales, the (R, rows) scores
// (then probabilities), the per-head max and denominator; the merge reuses
// the base for its (splits, R) weights and R denominators
struct Layout {
  size_t kc, vc, ksc, vsc, sp, ml, bytes;
};

__host__ __device__ inline Layout layout(int R, int D, int page, int kv_bits, int splits) {
  const size_t tmax = (size_t)kPagesPerSplit * page;
  Layout l;
  l.kc = align16(sizeof(float) * R * D);
  l.vc = l.kc + align16(tmax * row_bytes(kv_bits, D));
  l.ksc = l.vc + align16(tmax * row_bytes(kv_bits, D));
  l.vsc = l.ksc + sizeof(float) * tmax;
  l.sp = l.vsc + sizeof(float) * tmax;
  l.ml = l.sp + sizeof(float) * R * tmax;
  const size_t split_bytes = l.ml + sizeof(float) * 2 * R;
  const size_t merge_bytes = sizeof(float) * ((size_t)splits * R + R);
  l.bytes = split_bytes > merge_bytes ? split_bytes : merge_bytes;
  return l;
}

struct Args {
  const void* q;
  const uint8_t* k_pages;
  const uint8_t* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* block_table;
  const int* seq_lens;
  float* out;
  float* ws;       // (B·Hkv·splits, R, D) weighted values, then (B·Hkv·splits, 2, R) max / denom
  int* counters;   // (B·Hkv,) arrivals, 0 between calls
  int H, Hkv, D, page, maxp, copy_w;
  float softmax_scale;
};

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(W));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the pool row of token t of the split (pids: its block-table entries)
__device__ __forceinline__ long long pool_row(const int* pids, int t, int page, int Hkv, int g) {
  return ((long long)pids[t / page] * page + t % page) * Hkv + g;
}

template <int W>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* pages, const int* pids,
                                          int n_rows, int rb, int page, int Hkv, int g) {
  const int per_row = rb / W;
  for (int i = threadIdx.x; i < n_rows * per_row; i += kThreads) {
    const int t = i / per_row, off = (i - t * per_row) * W;
    cp_async<W>(dst + (size_t)t * rb + off, pages + pool_row(pids, t, page, Hkv, g) * rb + off);
  }
}

// elements 4c .. 4c+3 of a stored row, as f32 codes (bf16 values at kv 0)
template <int KV_BITS>
__device__ __forceinline__ float4 chunk(const uint8_t* row, int c) {
  if constexpr (KV_BITS == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 8 * c);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  } else if constexpr (KV_BITS == 8) {
    const char4 v = *reinterpret_cast<const char4*>(row + 4 * c);
    return make_float4(v.x, v.y, v.z, v.w);
  } else {
    // offset-binary nibbles, the low one the even element (pack_int4)
    const int v = *reinterpret_cast<const uint16_t*>(row + 2 * c);
    return make_float4((float)((v & 0xF) - 8), (float)(((v >> 4) & 0xF) - 8),
                       (float)(((v >> 8) & 0xF) - 8), (float)(((v >> 12) & 0xF) - 8));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(fmaf(w, v.x, a.x), fmaf(w, v.y, a.y), fmaf(w, v.z, a.z), fmaf(w, v.w, a.w));
}

template <int KV_BITS, bool Q_BF16>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int pids[kPagesPerSplit];
  __shared__ int is_last;
  const int b = blockIdx.x, g = blockIdx.y, s = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.H / a.Hkv, D = a.D, page = a.page, n_chunks = D / 4;
  const int p0 = s * kPagesPerSplit;
  if (tid < kPagesPerSplit && p0 + tid < a.maxp)
    pids[tid] = a.block_table[(long long)b * a.maxp + p0 + tid];
  const int len = max(a.seq_lens[b], 0);
  const int n_used = min(a.maxp, (len + page - 1) / page);
  const int n_split = (n_used + kPagesPerSplit - 1) / kPagesPerSplit;
  const long long q_off = ((long long)b * a.H + (long long)g * R) * D;
  if (n_split == 0) {
    if (s == 0)
      for (int i = tid; i < R * D; i += kThreads) a.out[q_off + i] = 0.f;
    return;
  }
  if (s >= n_split) return;

  const Layout L = layout(R, D, page, KV_BITS, splits);
  const int rb = row_bytes(KV_BITS, D), tmax = kPagesPerSplit * page;
  float* qs = reinterpret_cast<float*>(smem);
  uint8_t* kc = smem + L.kc;
  uint8_t* vc = smem + L.vc;
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + R;
  // valid rows of this split: every one is < seq_len (and the split holds ≥ 1)
  const int n_rows = min(len - p0 * page, min(n_used - p0, kPagesPerSplit) * page);

  __syncthreads();  // pids
  if (a.copy_w == 16) {
    copy_rows<16>(kc, a.k_pages, pids, n_rows, rb, page, a.Hkv, g);
    copy_rows<16>(vc, a.v_pages, pids, n_rows, rb, page, a.Hkv, g);
  } else if (a.copy_w == 8) {
    copy_rows<8>(kc, a.k_pages, pids, n_rows, rb, page, a.Hkv, g);
    copy_rows<8>(vc, a.v_pages, pids, n_rows, rb, page, a.Hkv, g);
  } else {
    copy_rows<4>(kc, a.k_pages, pids, n_rows, rb, page, a.Hkv, g);
    copy_rows<4>(vc, a.v_pages, pids, n_rows, rb, page, a.Hkv, g);
  }
  if (KV_BITS) {
    for (int t = tid; t < n_rows; t += kThreads) {
      const long long row = pool_row(pids, t, page, a.Hkv, g);
      cp_async<4>(ksc + t, a.k_scale + row);
      cp_async<4>(vsc + t, a.v_scale + row);
    }
  }
  // q under the copies in flight
  for (int i = tid; i < R * D; i += kThreads)
    qs[i] = Q_BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[q_off + i])
                   : static_cast<const float*>(a.q)[q_off + i];
  cp_async_wait_all();
  __syncthreads();

  // scores: one warp per token, lanes over D; all R heads against one chunk
  for (int t = warp; t < n_rows; t += kWarps) {
    float4 kv[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = lane + 32 * j;
      kv[j] = c < n_chunks ? chunk<KV_BITS>(kc + (size_t)t * rb, c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float sc = (KV_BITS ? ksc[t] : 1.f) * a.softmax_scale;
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = lane + 32 * j;
        if (c < n_chunks) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + 4 * c);
          dot = fmaf(qv.x, kv[j].x, dot);
          dot = fmaf(qv.y, kv[j].y, dot);
          dot = fmaf(qv.z, kv[j].z, dot);
          dot = fmaf(qv.w, kv[j].w, dot);
        }
      }
      dot = warp_sum(dot);
      if (lane == 0) sp[r * tmax + t] = dot * sc;
    }
  }
  __syncthreads();

  // softmax over the split's rows: one warp per head; the probabilities
  // take the V rows' scales, the denominator does not
  for (int r = warp; r < R; r += kWarps) {
    float* sr = sp + r * tmax;
    float mx = kNegInf;
    for (int t = lane; t < n_rows; t += 32) mx = fmaxf(mx, sr[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n_rows; t += 32) {
      const float p = expf(sr[t] - mx);
      sum += p;
      sr[t] = KV_BITS ? p * vsc[t] : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  __syncthreads();

  // weighted values, each (head, 4-element chunk) summed over rows in order
  const long long bg = (long long)b * a.Hkv + g;
  const long long n_parts = (long long)gridDim.x * gridDim.y * splits;
  float* part_acc = a.ws + (bg * splits + s) * R * D;
  float* part_ml = a.ws + n_parts * R * D + (bg * splits + s) * 2 * R;
  for (int i = tid; i < R * n_chunks; i += kThreads) {
    const int r = i / n_chunks, c = i - r * n_chunks;
    const float* pr = sp + r * tmax;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < n_rows; ++t) acc = fma4(pr[t], chunk<KV_BITS>(vc + (size_t)t * rb, c), acc);
    if (n_split == 1) {
      const float l = l_s[r];
      *reinterpret_cast<float4*>(a.out + q_off + r * D + 4 * c) =
          make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
    } else {
      *reinterpret_cast<float4*>(part_acc + r * D + 4 * c) = acc;
    }
  }
  if (n_split == 1) return;
  if (tid < R) {
    part_ml[tid] = m_s[tid];
    part_ml[R + tid] = l_s[tid];
  }

  // the last split of (b, g) to arrive merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + bg, 1);
    is_last = prev == n_split - 1;
    if (is_last) a.counters[bg] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // merge in split order 0, 1, 2, …: the weights exp(m_k − max m), then the
  // denominator and the weighted values summed over k in that order
  const float* acc0 = a.ws + bg * splits * R * D;
  const float* ml0 = a.ws + n_parts * R * D + bg * splits * 2 * R;
  float* w = reinterpret_cast<float*>(smem);   // (n_split, R): exp(m_k − max_k m_k)
  float* den = w + n_split * R;                // (R,)
  for (int r = warp; r < R; r += kWarps) {
    float mx = kNegInf;
    for (int k = lane; k < n_split; k += 32) mx = fmaxf(mx, __ldcg(ml0 + k * 2 * R + r));
    mx = warp_max(mx);
    for (int k = lane; k < n_split; k += 32) w[k * R + r] = expf(__ldcg(ml0 + k * 2 * R + r) - mx);
  }
  __syncthreads();
  if (tid < R) {
    float d = 0.f;
    for (int k = 0; k < n_split; ++k) d = fmaf(w[k * R + tid], __ldcg(ml0 + k * 2 * R + R + tid), d);
    den[tid] = d;
  }
  __syncthreads();
  for (int i = tid; i < R * n_chunks; i += kThreads) {
    const int r = i / n_chunks, c = i - r * n_chunks;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < n_split; ++k)
      o = fma4(w[k * R + r], __ldcg(reinterpret_cast<const float4*>(acc0 + ((long long)k * R + r) * D + 4 * c)), o);
    const float l = den[r];
    *reinterpret_cast<float4*>(a.out + q_off + r * D + 4 * c) =
        make_float4(o.x / l, o.y / l, o.z / l, o.w / l);
  }
}

// opt in to `bytes` of dynamic shared memory above the default 48 KB, once
// per kernel instance and device (again only for a larger size)
template <typename F>
cudaError_t opt_in(F* kernel, size_t bytes, size_t* opted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  return cudaSuccess;
}

template <int KV_BITS, bool Q_BF16>
cudaError_t launch(const Args& a, int B, int splits, cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  const size_t smem = layout(a.H / a.Hkv, a.D, a.page, KV_BITS, splits).bytes;
  auto kernel = paged_attn_kernel<KV_BITS, Q_BF16>;
  cudaError_t err = opt_in(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, a.Hkv, splits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KV_BITS>
cudaError_t launch_q(int q_bf16, const Args& a, int B, int splits, cudaStream_t s) {
  return q_bf16 ? launch<KV_BITS, true>(a, B, splits, s) : launch<KV_BITS, false>(a, B, splits, s);
}

}  // namespace

extern "C" int paged_attn_pages_per_split() { return kPagesPerSplit; }

// out (B, H, D) f32. q (B, H, D) bf16 (q_bf16) or f32; pages (P, page, Hkv,
// D) bf16 (kv_bits 0) / int8 (8) or (P, page, Hkv, D/2) uint8 (4), their
// rows copied copy_w (16, 8 or 4) bytes at a time; scales (P, page, Hkv, 1)
// f32, unused at kv_bits 0; block_table (B, maxp) int32; seq_lens (B,)
// int32; ws ≥ B·Hkv·splits·(R·D + 2R) f32 and counters (B·Hkv,) int32, all
// 0, with splits = max(1, ceil(maxp / paged_attn_pages_per_split())). D a multiple
// of 8, at most 512. Returns the cudaError_t of the launch.
extern "C" int paged_attn_launch(const void* q, int q_bf16, const void* k_pages,
                                 const void* v_pages, const float* k_scale,
                                 const float* v_scale, const int* block_table,
                                 const int* seq_lens, float* out, float* ws, int* counters,
                                 int B, int H, int Hkv, int D, int page, int maxp,
                                 int kv_bits, int copy_w, float softmax_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, static_cast<const uint8_t*>(k_pages), static_cast<const uint8_t*>(v_pages),
               k_scale, v_scale, block_table, seq_lens, out, ws, counters,
               H, Hkv, D, page, maxp, copy_w, softmax_scale};
  const int splits = maxp > kPagesPerSplit ? (maxp + kPagesPerSplit - 1) / kPagesPerSplit : 1;
  if (kv_bits == 8) return launch_q<8>(q_bf16, a, B, splits, s);
  if (kv_bits == 4) return launch_q<4>(q_bf16, a, B, splits, s);
  return launch_q<0>(q_bf16, a, B, splits, s);
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
