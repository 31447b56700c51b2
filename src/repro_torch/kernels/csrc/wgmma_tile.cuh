// wgmma_tile.cuh — the pieces of a bf16 tensor-core tile that the
// dequantize-matmul cores share: csrc/qmm_core.cuh (kernels B5 qmm and B7
// qmm_qout, int8 and packed-int4 codes) and csrc/qmm_bitplane.cu (kernel
// B11, bit-plane words). One 128 × 256 output tile per block, K steps of
// 64; x tiles bf16, K-major, 128B-swizzled; each code tile is converted
// once per block into bf16 in the MN-major swizzled layout that wgmma
// m64n128k16 reads as a transposed B (atoms of 8 k rows × 64 columns,
// B_LBO apart along N and B_SBO along K).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace tc {

constexpr int kThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int BM = 128, BN = 256, BK = 64;  // kernels/qmm.py · TILES, qmm_bitplane.py · TILES
constexpr int ROW = 128;       // bytes of one swizzled row: BK bf16 of x, 64 bf16 of B

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W-byte cp.async of the first src_bytes of src (the rest zero-filled)
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(W), "r"(src_bytes) : "memory");
}
template <int W>
__device__ __forceinline__ void zero_piece(void* dst) {
  if constexpr (W == 16) *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  else if constexpr (W == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
  else *reinterpret_cast<uint32_t*>(dst) = 0;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte b of row r of a 128-byte-row tile under the 128B swizzle (16-byte
// chunk c of row r sits at chunk c ^ (r mod 8)), as wgmma reads it
__device__ __forceinline__ int swz(int r, int b) {
  return r * ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// x[m0 .. m0+BM, k0 .. k0+BK] → xs (K-major, swizzled), in W-byte pieces:
// cp.async for W ≥ 4, plain 2-byte copies where K or the base allow no
// more; rows ≥ M and columns ≥ k_end read as 0
template <int W>
__device__ __forceinline__ void load_x(uint8_t* xs, const __nv_bfloat16* x, int M, int K,
                                       int m0, int k0, int k_end) {
  constexpr int E = W / 2;             // bf16 per piece
  constexpr int PER_ROW = BK / E;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    const int m = m0 + r, k = k0 + c * E;
    const int valid = (m < M) ? 2 * min(max(k_end - k, 0), E) : 0;
    uint8_t* d = xs + swz(r, c * W);
    const __nv_bfloat16* s = x + (size_t)m * K + k;
    if constexpr (W >= 4) {
      if (valid) cp_async<W>(smem_u32(d), s, valid);
      else zero_piece<W>(d);
    } else {
      *reinterpret_cast<uint16_t*>(d) = valid ? *reinterpret_cast<const uint16_t*>(s) : 0;
    }
  }
}

// the bf16 B tile: atom (k/8, n/64) at (4·(k/8) + n/64)·1024 bytes
constexpr int B_LBO = 1024;              // bytes between atoms along N
constexpr int B_SBO = (BN / 64) * 1024;  // ... along K (8 rows)

// a shared-memory matrix descriptor with the 128B swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d (+)= A · B for one 64 × 128 × 16 step of a warpgroup: A K-major, B
// MN-major (transposed, TNSP_B 1) or K-major (TNSP_B 0), both from shared
// memory; scale_d = 0 starts from 0
template <int TNSP_B = 1>
__device__ __forceinline__ void wgmma_step(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TNSP_B));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading d before the wgmma that writes it is done
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace tc

// the widest piece (≤ cap bytes, a power of two) that both the base
// address and the row stride are multiples of
inline int widest(const void* p, long long stride, int cap) {
  int w = cap;
  while (w > 1 && ((reinterpret_cast<uintptr_t>(p) | (uintptr_t)stride) % w)) w >>= 1;
  return w;
}

}  // namespace
