// Shared pieces of the attention kernels (forward: attention.cu, backward:
// attention_bwd.cu): sizes, strided addressing, the additive mask row in
// shared memory, and the Hopper building blocks of the bf16 kernels:
//   * tiles of [rows, 64] bf16 in shared memory, one 128-byte row per query or
//     key, 128-byte swizzled, written by TMA (cp.async.bulk.tensor) from a 4-D
//     tensor map over (64, L, H, B) with the tensor's own byte strides; rows
//     past L arrive as zeros;
//   * mbarriers for "tile has landed" and "tile is read";
//   * wgmma m64n64k16 with A from registers or from a tile and B read from a
//     tile by the tensor cores themselves, either K-major (the product sums
//     over the 64 columns: q.k^T, dO.v^T) or MN-major (it sums over the tile's
//     rows: p.v, dS.k, p^T.dO, dS^T.q), so no tile is ever transposed in
//     shared memory;
//   * ldmatrix of a swizzled tile into wgmma's A fragments (the block's own q,
//     dO, k or v rows, loaded once).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing links against libcuda
#include <math_constants.h>
#include <stdio.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kDh = 64;       // head width both kernels are written for
constexpr int kMaxL = 512;    // longest sequence (the mask row lives in shared memory)
constexpr int kThreads = 128; // block of the f32 kernels

struct Strides {
  long long b, h, l;  // in elements; Dh is contiguous
};

// the additive mask row of batch element b as f32, -inf past L (the f32 kernels' blocks)
template <typename T>
__device__ void fill_mask(float* mask_s, const T* __restrict__ mask, long long mask_sb, int b, int L) {
  for (int i = threadIdx.x; i < kMaxL; i += kThreads)
    mask_s[i] = i < L ? (mask ? to_f(mask[(size_t)b * mask_sb + i]) : 0.f) : -CUDART_INF_F;
}

// ------------------------------------------------------------------ bf16
constexpr int kRowBytes = kDh * 2;        // 128: one row of a tile is one swizzle row
constexpr int kTile64 = 64 * kRowBytes;   // a [64, 64] bf16 tile
constexpr int kWgThreads = 128;           // a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// --- mbarrier (addresses are 32-bit shared-window addresses)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of asynchronous copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// returns once the barrier's phase of this parity has completed; a wait of
// more than two seconds (a copy that never lands) traps instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      if (now - t0 > 2000000000ull) __trap();
    }
  }
}

// --- TMA: the box of rows row .. row + box_rows of (b, h), 64 columns, into a
// swizzled tile; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row,
                                              int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}
// contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --- wgmma
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading or moving an accumulator across the wait
template <int NB> __device__ __forceinline__ void fence_acc(float (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile with 128-byte
// rows: groups of eight rows lie 1024 bytes apart (the stride offset); the
// leading offset is not read for these shapes (one swizzle row covers all 64
// columns).  The same encoding serves the K-major and the MN-major reading;
// the instruction's transpose bit chooses.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define DRIN_ACC4(d, j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d[64 x 64] (+)= a[64 x 16] . B; B is 16 x 64 through `desc`; kTransB = 1
// reads an MN-major tile.  The accumulator fragment is mma.sync's, warp w of
// the warpgroup holding rows 16 w .. 16 w + 15: d[j][0..1] row lane / 4,
// columns 8 j + 2 (lane % 4) + {0, 1}; d[j][2..3] the same of row lane / 4 + 8.
template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : DRIN_ACC4(d, 0), DRIN_ACC4(d, 1), DRIN_ACC4(d, 2), DRIN_ACC4(d, 3), DRIN_ACC4(d, 4),
        DRIN_ACC4(d, 5), DRIN_ACC4(d, 6), DRIN_ACC4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB));
}

// the same with A read from shared memory too: a K-major [64 x 16] slice of a tile
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : DRIN_ACC4(d, 0), DRIN_ACC4(d, 1), DRIN_ACC4(d, 2), DRIN_ACC4(d, 3), DRIN_ACC4(d, 4),
        DRIN_ACC4(d, 5), DRIN_ACC4(d, 6), DRIN_ACC4(d, 7)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
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

// wgmma's A fragments of rows r0 .. r0 + 15 (r0 a multiple of 16), all 64
// columns, out of a swizzled tile: 16-byte chunk c of row r lies at chunk
// c ^ (r % 8) of that row
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], uint32_t tile, int r0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = kk * 2 + (lane >> 4);
    const uint32_t addr = tile + row * kRowBytes + ((chunk ^ (row & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(addr));
  }
}

// dynamic shared memory from its first 1024-byte boundary on (the swizzle
// pattern is a function of the address; the launch asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library needs no -lcuda
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// The tensor map of one [B, H, L, 64] bf16 tensor read in boxes of box_rows
// rows of one (b, h): dimensions (64, L, H, B), innermost first, with the
// tensor's own strides.  Encoding takes a few microseconds on the host and a
// model hands over the same buffers again and again, so the last maps of each
// thread are kept by (pointer, shape, strides, box).
struct MapKey {
  const void* base;
  long long sb, sh, sl;
  int B, H, L, box_rows;
};
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
constexpr int kMapSlots = 32;

inline int tile_map(CUtensorMap* out, const void* base, Strides s, int B, int H, int L, int box_rows) {
  thread_local MapSlot slots[kMapSlots];
  thread_local int next = 0;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.base = base, key.sb = s.b, key.sh = s.h, key.sl = s.l, key.B = B, key.H = H, key.L = L,
  key.box_rows = box_rows;
  for (int i = 0; i < kMapSlots; ++i)
    if (slots[i].used && memcmp(&slots[i].key, &key, sizeof key) == 0) {
      *out = slots[i].map;
      return 0;
    }
  EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  // the encode call wants the device's context current on this thread; a thread that has not
  // touched the runtime yet (autograd's, on its first backward) gets it here
  cudaFree(nullptr);
  const cuuint64_t dims[4] = {(cuuint64_t)kDh, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.l * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.b * 2};  // bytes
  const cuuint32_t box[4] = {(cuuint32_t)kDh, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  MapSlot& slot = slots[next];
  const CUresult r = encode(&slot.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    slot.used = false;
    fprintf(stderr,
            "drin attention: cuTensorMapEncodeTiled failed (%d) for base %p, [B=%d, H=%d, L=%d, 64] with "
            "element strides (%lld, %lld, %lld), box of %d rows\n",
            static_cast<int>(r), base, B, H, L, s.b, s.h, s.l, box_rows);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slot.key = key;
  slot.used = true;
  next = (next + 1) % kMapSlots;
  *out = slot.map;
  return 0;
}

// opt in to `bytes` of dynamic shared memory and to the largest shared-memory
// carve-out (so that as many blocks as the registers allow share an SM), once
// per kernel
template <typename K> inline cudaError_t allow_smem(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// blocks of `kernel` that share one SM at this block size and shared memory; negative on an error
template <typename K> inline int blocks_per_sm(K kernel, int threads, int bytes) {
  int n = 0;
  if (allow_smem(kernel, bytes) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) != cudaSuccess) return -1;
  return n;
}

}  // namespace
