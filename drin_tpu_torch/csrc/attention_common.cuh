// Shared pieces of the attention kernels (forward: attention.cu, backward:
// attention_bwd.cu): sizes, strided addressing, the additive mask row in
// shared memory, and, on top of hopper.cuh (mbarriers, TMA, wgmma, tensor
// maps), what the bf16 kernels share (the f32 forward reads its tiles through
// the same 4-D maps, in boxes of 32 columns):
//   * tiles of [rows, 64] bf16 in shared memory, one 128-byte row per query or
//     key, 128-byte swizzled, written by TMA (cp.async.bulk.tensor) from a 4-D
//     tensor map over (64, L, H, B) with the tensor's own byte strides; rows
//     past L arrive as zeros;
//   * wgmma products that read B either K-major (the product sums over the 64
//     columns: q.k^T, dO.v^T) or MN-major (it sums over the tile's rows: p.v,
//     dS.k, p^T.dO, dS^T.q), so no tile is ever transposed in shared memory.
#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kDh = 64;       // head width both kernels are written for
constexpr int kMaxL = 512;    // longest sequence (the mask row lives in shared memory)
constexpr int kThreads = 128; // block of the f32 kernels

struct Strides {
  long long b, h, l;  // in elements; Dh is contiguous
};

// the additive mask row of batch element b as f32, -inf past L, written by a
// block of kN threads (the f32 kernels' blocks)
template <typename T, int kN = kThreads>
__device__ void fill_mask(float* mask_s, const T* __restrict__ mask, long long mask_sb, int b, int L) {
  for (int i = threadIdx.x; i < kMaxL; i += kN)
    mask_s[i] = i < L ? (mask ? to_f(mask[(size_t)b * mask_sb + i]) : 0.f) : -CUDART_INF_F;
}

// ------------------------------------------------------------------ bf16
constexpr int kRowBytes = kDh * 2;        // 128: one row of a tile is one swizzle row
static_assert(kRowBytes == kSwizzleRow, "a head row is one swizzle row");
constexpr int kTile64 = 64 * kRowBytes;   // a [64, 64] bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kFltMax = 3.402823466e+38f;

// 2^x, one instruction; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bf16 kernels take the softmax in base 2: logit2 = (q.k) * (scale * log2 e)
// + mask2 and p = 2^(logit2 - max2), one FFMA, one FADD and one ex2 per
// logit.  mask2 = mask * log2 e would overflow for a dropped key (the mask
// holds about -3.4e38), so it is cut off at -FLT_MAX: still finite, still far
// larger than any q.k, so the logits of a row whose keys are all dropped stay
// equal and its softmax uniform.  Past L: -inf.
template <typename T>
__device__ void fill_mask_log2(float* mask_s, const T* __restrict__ mask, long long mask_sb, int b, int L,
                               int tid, int n) {
  for (int i = tid; i < kMaxL; i += n)
    mask_s[i] = i < L ? (mask ? fmaxf(to_f(mask[(size_t)b * mask_sb + i]) * kLog2e, -kFltMax) : 0.f)
                      : -CUDART_INF_F;
}
// The forward stores the row max m in natural units (as the f32 kernels and
// the plain version have it) and the backward turns it back into base 2, cut
// off like the mask.  The two roundings on the way need not return the max the
// forward worked with, and where every key of a row is dropped (logits of 1e9
// to 3e38) one float step is a whole power of two and more.  So the forward
// rounds m down until its base-2 form does not exceed its own max
// (natural_row_max), and the backward cuts the exponent off at 0 (exp2_le1: a
// probability before its normalisation is at most 1).  A row of equal logits
// then recomputes to P = 1 / L for any finite mask value, and any other row
// moves by a float step of its max at most.
__device__ __forceinline__ float row_max_log2(float m) { return fmaxf(m * kLog2e, -kFltMax); }
__device__ __forceinline__ float natural_row_max(float m2) {
  float m = m2 * kLn2;
  while (row_max_log2(m) > m2) m = nextafterf(m, -CUDART_INF_F);
  return m;
}
__device__ __forceinline__ float exp2_le1(float x) {
  float y;
  asm("min.NaN.f32 %0, %1, 0f00000000;\n" : "=f"(y) : "f"(x));  // a NaN stays one
  return ex2(y);
}

// --- TMA: the box of rows row .. row + box_rows of (b, h), from column x on
// (all 64 columns of a bf16 tensor, 32 of a float32 one), into a swizzled
// tile; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row,
                                              int h, int b, int x = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(row), "r"(h), "r"(b)
      : "memory");
}
// d[64 x 64] = a[64 x 64] . T^T for a tile T of 64 rows: the product over
// the 64 columns, four k-steps of 32 bytes along the swizzle row.
// These only enqueue the instructions; the caller fences before and commits after.
__device__ __forceinline__ void mma_rows_of(float (&d)[8][4], const uint32_t (&a)[4][4], uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_n64<0>(d, a[kk], tile_desc(tile + kk * 32), kk > 0);
}

// d[64 x 64] = A . T^T with A the [64 x 64] tile at `a_tile`, read from shared memory as well
__device__ __forceinline__ void mma_rows_of(float (&d)[8][4], uint32_t a_tile, uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64<0>(d, tile_desc(a_tile + kk * 32), tile_desc(tile + kk * 32), kk > 0);
}

// d[64 x 64] += a[64 x R] . T for a tile T of R rows: the product over the
// tile's rows, R / 16 k-steps of sixteen rows (2048 bytes) each.
template <int KS>
__device__ __forceinline__ void mma_over_rows(float (&d)[8][4], const uint32_t (&a)[KS][4], uint32_t tile,
                                              int accumulate_first) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_n64<1>(d, a[kk], tile_desc(tile + kk * 16 * kRowBytes), kk > 0 ? 1 : accumulate_first);
}

// the f32 fragment of a [64 x 16 NB/2] product as the bf16 A operand of the next one
template <int NB>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NB / 2][4], const float (&s)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// ------------------------------------------------------------------ host
// The tensor map of one [B, H, L, 64] bf16 (elem_bytes 2) or float32 (4)
// tensor read in boxes of box_rows rows of one (b, h) and 128 bytes of
// columns (the widest box a 128-byte swizzle takes: all 64 bf16 columns, or
// 32 float32 ones, so a float32 tile arrives as two loads into two atoms):
// dimensions (64, L, H, B), innermost first, with the tensor's own strides
// (kept by encode_map's cache).
inline int tile_map(CUtensorMap* out, const void* base, Strides s, int B, int H, int L, int box_rows,
                    int elem_bytes = 2) {
  const cuuint64_t dims[4] = {(cuuint64_t)kDh, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t e = (cuuint64_t)elem_bytes;
  const cuuint64_t strides[3] = {(cuuint64_t)s.l * e, (cuuint64_t)s.h * e, (cuuint64_t)s.b * e};  // bytes
  const cuuint32_t box[4] = {(cuuint32_t)(kSwizzleRow / elem_bytes), (cuuint32_t)box_rows, 1, 1};
  return encode_map(out, base, 4, dims, strides, box,
                    elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

}  // namespace
