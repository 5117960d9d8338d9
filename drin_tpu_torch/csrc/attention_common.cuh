// Shared pieces of the attention kernels (forward: attention.cu, backward:
// attention_bwd.cu): tile sizes, strided addressing, the additive mask row in
// shared memory, and the bf16 tensor-core helpers (cp.async tile loads,
// mma.sync m16n8k16, ldmatrix.trans).
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kDh = 64;       // head width both kernels are written for
constexpr int kMaxL = 512;    // longest sequence (the mask row lives in shared memory)
constexpr int kThreads = 128;

struct Strides {
  long long b, h, l;  // in elements; Dh is contiguous
};

template <typename T>
__device__ void fill_mask(float* mask_s, const T* __restrict__ mask, long long mask_sb, int b, int L) {
  for (int i = threadIdx.x; i < kMaxL; i += kThreads)
    mask_s[i] = i < L ? (mask ? to_f(mask[(size_t)b * mask_sb + i]) : 0.f) : -CUDART_INF_F;
}

// ------------------------------------------------------------------ bf16
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kRow = kDh + 8;      // padded tile row (elements): conflict-free fragment loads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes == 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0 .. r0 + 64 of one (b, h) matrix [L, 64] into a padded tile, zeros past L
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*tile)[kRow], const __nv_bfloat16* __restrict__ src,
                                          long long stride_l, int r0, int L) {
#pragma unroll
  for (int i = 0; i < (kBK * kDh / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / 8, col = (c % 8) * 8;
    const bool in = r0 + r < L;
    const __nv_bfloat16* g = src + (size_t)(in ? r0 + r : 0) * stride_l + col;
    cp_async16(&tile[r][col], g, in ? 16 : 0);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four transposed 8x8 blocks of a [rows][kRow] tile: rows r0 + {0..7, 8..15},
// columns c0 and c0 + 8 -> the B operands (b0, b1) of column block c0 and
// (b2, b3) of column block c0 + 8 for a product that sums over the tile's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], __nv_bfloat16 (*tile)[kRow], int r0,
                                                  int c0, int lane) {
  const uint32_t addr = smem_u32(&tile[r0 + (lane % 16)][c0 + (lane / 16) * 8]);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

}  // namespace
