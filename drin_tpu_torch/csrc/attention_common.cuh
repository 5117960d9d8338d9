// Shared pieces of the attention kernels (forward: attention.cu, backward:
// attention_bwd.cu): sizes, strided addressing, the additive mask row in
// shared memory, and, on top of hopper.cuh (mbarriers, TMA, wgmma, tensor
// maps), what the bf16 kernels share (the f32 kernels read their tiles through
// the same 4-D maps, in boxes of 32 columns, and share the split-precision
// TF32 pieces of the last section):
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

struct Strides {
  long long b, h, l;  // in elements; Dh is contiguous
};

// the additive mask row of batch element b as f32, -inf past L, written by a
// block of kN threads (the f32 kernels' blocks)
template <typename T, int kN>
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

// ------------------------------------------------------------------- f32
// The float32 kernels take every product on the tensor cores in split
// precision.  wgmma takes float32 data only as TF32 (10 mantissa bits), so
// every operand x is split into x = hi + lo, hi = x rounded to TF32 and lo =
// (x - hi) rounded to TF32 (both to nearest, ties away: cvt.rna), and each
// product is taken as lo.hi + hi.lo + hi.hi in f32 accumulators; lo.lo
// (2^-22 of the product) is dropped, as CUTLASS's 3xTF32
// (OpMultiplyAddFastF32) drops it.  What remains differs from an f32 FMA loop
// by a few f32 roundings.  A [64, 64] f32 tile is two 128-byte-swizzled atoms
// of 32 columns, each arriving by its own TMA box.
constexpr int kF32Atom = 64 * kSwizzleRow;        // 64 rows x 32 f32, one swizzle row each
constexpr int kF32Tile = 2 * kF32Atom;            // [64, 64] f32: columns 0-31 | 32-63

// byte offset of element (r, c) in a [64, 64] f32 tile of two swizzled atoms
__device__ __forceinline__ int f32_at(int r, int c) {
  return (c >> 5) * kF32Atom + r * kSwizzleRow + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// x rounded to TF32 (to nearest, ties away from zero), low 13 bits clear
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);  // x - hi is exact
}
__device__ __forceinline__ void split_tf32(const float4& x, float4& hi, float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// all kN threads: `tiles` f32 tiles at `raw` split where they lie, hi written
// over the raw values and lo into the tiles at `lo` (elementwise, so the
// layout is kept: both read K-major, as the raw tile would be)
template <int kN>
__device__ __forceinline__ void split_in_place(unsigned char* raw, unsigned char* lo, int tiles) {
  for (int i = threadIdx.x; i < tiles * kF32Tile / 16; i += kN) {
    float4* p = reinterpret_cast<float4*>(raw + i * 16);
    float4 h, l;
    split_tf32(*p, h, l);
    *p = h;
    *reinterpret_cast<float4*>(lo + i * 16) = l;
  }
}

// kN threads (tid 0 .. kN - 1): the split tiles hi, lo [64, 64] transposed into thi, tlo
// (row c of the result holds column c), for a product that sums over the
// source's rows (.tf32 reads B only K-major); with kRaw, `hi` is a raw tile,
// split on the way (`lo` is not read).  The source rows come in the order 0
// 2 4 6 1 3 5 7 within each group of 8: an accumulator hands a thread columns
// 2t and 2t + 1 of each group, which split_frags puts at A positions t and
// t + 4, so B's rows along the sum must follow the same order.  Chunk i of a
// result row holds source rows 8 (i / 2) + (i % 2) + {0, 2, 4, 6}.
template <int kN, bool kRaw = false>
__device__ __forceinline__ void transpose_split(unsigned char* thi, unsigned char* tlo, const unsigned char* hi,
                                                const unsigned char* lo, int tid) {
  for (int i = tid; i < kF32Tile / 16; i += kN) {
    const int c = i % 64, ch = i / 64, r0 = (ch >> 1) * 8 + (ch & 1);
    float4 h, l;
    h.x = *reinterpret_cast<const float*>(hi + f32_at(r0, c));
    h.y = *reinterpret_cast<const float*>(hi + f32_at(r0 + 2, c));
    h.z = *reinterpret_cast<const float*>(hi + f32_at(r0 + 4, c));
    h.w = *reinterpret_cast<const float*>(hi + f32_at(r0 + 6, c));
    if (kRaw) {
      const float4 x = h;
      split_tf32(x, h, l);
    } else {
      l.x = *reinterpret_cast<const float*>(lo + f32_at(r0, c));
      l.y = *reinterpret_cast<const float*>(lo + f32_at(r0 + 2, c));
      l.z = *reinterpret_cast<const float*>(lo + f32_at(r0 + 4, c));
      l.w = *reinterpret_cast<const float*>(lo + f32_at(r0 + 6, c));
    }
    const int at = (ch >> 3) * kF32Atom + c * kSwizzleRow + (((ch & 7) ^ (c & 7)) << 4);
    *reinterpret_cast<float4*>(thi + at) = h;
    *reinterpret_cast<float4*>(tlo + at) = l;
  }
}

// the A fragments (hi and lo) of rows r0 .. r0 + 15 of a raw [64, 64] f32
// tile, all 64 columns: 8 k-steps of 8 columns (wgmma_tf32_n64's layout)
__device__ __forceinline__ void load_split_frags(uint32_t (&hi)[8][4], uint32_t (&lo)[8][4],
                                                 const unsigned char* tile, int r0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = *reinterpret_cast<const float*>(tile + f32_at(r0 + g + (i & 1) * 8, kk * 8 + t + (i >> 1) * 4));
      float h, l;
      split_tf32(x, h, l);
      hi[kk][i] = __float_as_uint(h);
      lo[kk][i] = __float_as_uint(l);
    }
}

// the f32 accumulator of a [64 x 64] product as the split A fragments of the
// next product, which sums over its 64 columns: position t of k-step j is
// column 8 j + 2 t, position t + 4 column 8 j + 2 t + 1 (no shuffle; the B
// tile's rows follow, transpose_split)
__device__ __forceinline__ void split_frags(uint32_t (&hi)[8][4], uint32_t (&lo)[8][4], const float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float pv[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split_tf32(pv[i], h, l);
      hi[j][i] = __float_as_uint(h);
      lo[j][i] = __float_as_uint(l);
    }
  }
}

// pins the fragments' last writes before the caller's wgmma_fence: without
// it the compiler may sink the split past the fence, and ptxas then fences
// (and so serializes) the products that read them (warning C7519)
__device__ __forceinline__ void fence_frags(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// one k-step (8 columns) of d (+)= A . B^T in split precision, lo.hi +
// hi.lo + hi.hi; A as register fragments, B's hi and lo tiles K-major
__device__ __forceinline__ void mma_step(float (&d)[8][4], const uint32_t (&ahi)[8][4], const uint32_t (&alo)[8][4],
                                         int kk, uint32_t bhi, uint32_t blo, int accumulate) {
  const uint32_t off = (kk >> 2) * kF32Atom + (kk & 3) * 32;
  wgmma_tf32_n64(d, alo[kk], tile_desc(bhi + off), accumulate);
  wgmma_tf32_n64(d, ahi[kk], tile_desc(blo + off), 1);
  wgmma_tf32_n64(d, ahi[kk], tile_desc(bhi + off), 1);
}

// the same with A's hi and lo tiles read from shared memory (K-major, as B)
__device__ __forceinline__ void mma_step(float (&d)[8][4], uint32_t ahi, uint32_t alo, int kk, uint32_t bhi,
                                         uint32_t blo, int accumulate) {
  const uint32_t off = (kk >> 2) * kF32Atom + (kk & 3) * 32;
  wgmma_tf32_ss_n64(d, tile_desc(alo + off), tile_desc(bhi + off), accumulate);
  wgmma_tf32_ss_n64(d, tile_desc(ahi + off), tile_desc(blo + off), 1);
  wgmma_tf32_ss_n64(d, tile_desc(ahi + off), tile_desc(bhi + off), 1);
}

// d (+)= A . B^T over 64 columns in split precision, 8 k-steps.  These only
// enqueue the instructions; the caller fences before and commits after.
template <class A>
__device__ __forceinline__ void mma_split(float (&d)[8][4], const A& ahi, const A& alo, uint32_t bhi, uint32_t blo,
                                          int accumulate_first) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_step(d, ahi, alo, kk, bhi, blo, kk > 0 ? 1 : accumulate_first);
}

// two independent split products with their k-steps in turns: two chains of
// dependent accumulations, so that the tensor cores need not wait for one
// wgmma's sum before the next starts
template <class A1, class A2>
__device__ __forceinline__ void mma_split2(float (&d1)[8][4], const A1& a1hi, const A1& a1lo, uint32_t b1hi,
                                           uint32_t b1lo, float (&d2)[8][4], const A2& a2hi, const A2& a2lo,
                                           uint32_t b2hi, uint32_t b2lo, int accumulate_first) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma_step(d1, a1hi, a1lo, kk, b1hi, b1lo, kk > 0 ? 1 : accumulate_first);
    mma_step(d2, a2hi, a2lo, kk, b2hi, b2lo, kk > 0 ? 1 : accumulate_first);
  }
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace
