// Hopper (sm_90a) building blocks shared by the kernels (attention.cu,
// attention_bwd.cu, gcn_layer.cu, linear_f32.cu):
//   * mbarriers for "tile has landed" and "tile is read", with waits that trap
//     instead of hanging the card;
//   * TMA copies (cp.async.bulk) and the host-side encoding of tensor maps
//     through the runtime (no -lcuda), with a small per-thread cache;
//   * wgmma m64n64k16 (bf16 in, f32 accumulators) with A from registers or
//     from shared memory and B read from a 128-byte-swizzled tile, K-major or
//     MN-major; wgmma m64n64k8 with TF32 operands (A from registers or from
//     shared memory, B K-major: for .tf32 the instruction has no transposed
//     form), and m64n128k8 with A from registers;
//   * split-precision TF32: float32 operands split into TF32 hi + lo and each
//     product taken as lo.hi + hi.lo + hi.hi (float32 accuracy on the tensor
//     cores);
//   * ldmatrix of a swizzled [rows, 64] bf16 tile into wgmma's A fragments.
// Tiles are [rows, 64] bf16: one 128-byte row per matrix row, 128-byte
// swizzled (16-byte chunk c of row r lies at chunk c ^ (r % 8)); a float32
// tile of 64 columns is two such atoms of 32 columns each.  The float32 GCN
// kernels read [rows, 16] float32 tiles, one 64-byte row per matrix row,
// 64-byte swizzled (chunk c of row r at chunk c ^ (r / 2 % 4)).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing links against libcuda
#include <stdio.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kSwizzleRow = 128;           // bytes of one tile row: 64 bf16
constexpr int kTileBytes = 64 * kSwizzleRow;  // a [64, 64] bf16 tile
constexpr int kWgThreads = 128;            // a warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// --- TMA: the box at (x inner, y outer) of a 2-D tensor map into a swizzled
// tile; completion is counted in bytes on `bar`.  Parts of the box outside
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
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
// orders this thread's generic-proxy writes to shared memory before the
// async proxy's accesses (wgmma reading a tile that threads wrote, TMA
// writing over it later); a barrier after it makes that hold for all threads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from reading or moving an accumulator across the wait
template <int NB> __device__ __forceinline__ void fence_acc(float (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// Shared-memory matrix descriptor of a tile swizzled in rows of kSwizzle
// bytes (128: layout 1, 64: layout 2): groups of eight rows lie 8 * kSwizzle
// bytes apart (the stride offset); the leading offset is not read for these
// shapes (one k-step lies within a swizzle row).  The same encoding serves the
// K-major and the MN-major reading; the instruction's transpose bit chooses.
template <int kSwizzle = 128>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  static_assert(kSwizzle == 128 || kSwizzle == 64, "128- or 64-byte swizzle");
  constexpr uint64_t layout = kSwizzle == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(8 * kSwizzle >> 4) << 32) |
         (layout << 62);
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

// d[64 x 64] (+)= a[64 x 8] . B with TF32 operands; B is 8 x 64 through
// `desc`, read K-major (the only form .tf32 has).  A's fragment is mma.sync
// m16n8k8's: warp w of the warpgroup holds rows 16 w .. 16 w + 15, a[0] row
// lane / 4, column lane % 4; a[1] the same of row lane / 4 + 8; a[2], a[3]
// those of column lane % 4 + 4.  The accumulator is wgmma_n64's.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : DRIN_ACC4(d, 0), DRIN_ACC4(d, 1), DRIN_ACC4(d, 2), DRIN_ACC4(d, 3), DRIN_ACC4(d, 4),
        DRIN_ACC4(d, 5), DRIN_ACC4(d, 6), DRIN_ACC4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d[64 x 128] (+)= a[64 x 8] . B with TF32 operands, A from registers as in
// wgmma_tf32_n64; B is 8 x 128 through `desc` (K-major).  The accumulator is
// wgmma_n64's over 16 column groups of 8.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : DRIN_ACC4(d, 0), DRIN_ACC4(d, 1), DRIN_ACC4(d, 2), DRIN_ACC4(d, 3), DRIN_ACC4(d, 4),
        DRIN_ACC4(d, 5), DRIN_ACC4(d, 6), DRIN_ACC4(d, 7), DRIN_ACC4(d, 8), DRIN_ACC4(d, 9),
        DRIN_ACC4(d, 10), DRIN_ACC4(d, 11), DRIN_ACC4(d, 12), DRIN_ACC4(d, 13), DRIN_ACC4(d, 14),
        DRIN_ACC4(d, 15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// the same with A read from shared memory: a K-major [64 x 8] slice of a tile
// laid out as B's (for .tf32 both operands are K-major)
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : DRIN_ACC4(d, 0), DRIN_ACC4(d, 1), DRIN_ACC4(d, 2), DRIN_ACC4(d, 3), DRIN_ACC4(d, 4),
        DRIN_ACC4(d, 5), DRIN_ACC4(d, 6), DRIN_ACC4(d, 7)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// ------------------------------------------------- split-precision TF32
// wgmma takes float32 data only as TF32 (10 mantissa bits), so every operand
// x is split into x = hi + lo, hi = x rounded to TF32 and lo = (x - hi)
// rounded to TF32 (both to nearest, ties away: cvt.rna), and each product is
// taken as lo.hi + hi.lo + hi.hi in f32 accumulators; lo.lo (2^-22 of the
// product) is dropped, as CUTLASS's 3xTF32 (OpMultiplyAddFastF32) drops it.
// What remains differs from an f32 FMA loop by a few f32 roundings.

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

// pins the fragments' last writes before the caller's wgmma_fence: without
// it the compiler may sink the split past the fence, and ptxas then fences
// (and so serializes) the products that read them (warning C7519)
template <int K> __device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// one k-step (8 columns) of d (+)= A . B^T in split precision, lo.hi + hi.lo
// + hi.hi: A's split fragments in registers, B's hi and lo through their
// descriptors (K-major)
__device__ __forceinline__ void wgmma_tf32_split(float (&d)[8][4], const uint32_t (&ahi)[4],
                                                 const uint32_t (&alo)[4], uint64_t bhi, uint64_t blo,
                                                 int accumulate) {
  wgmma_tf32_n64(d, alo, bhi, accumulate);
  wgmma_tf32_n64(d, ahi, blo, 1);
  wgmma_tf32_n64(d, ahi, bhi, 1);
}

// wgmma's A fragments of rows r0 .. r0 + 15 (r0 a multiple of 16), all 64
// columns, out of a swizzled tile
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], uint32_t tile, int r0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = kk * 2 + (lane >> 4);
    const uint32_t addr = tile + row * kSwizzleRow + ((chunk ^ (row & 7)) << 4);
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

// A tensor map of up to 4 dimensions (innermost first, strides in bytes for
// dimensions 1..), bf16 unless `type` says otherwise, read in
// 128-byte-swizzled boxes unless `swizzle` says otherwise.  Encoding takes a few microseconds on the host
// and a model hands over the same buffers again and again, so the last maps
// of each thread are kept by (pointer, type, shape, strides, box).
struct MapKey {
  const void* base;
  int rank, type, swizzle;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
};
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
constexpr int kMapSlots = 32;

inline int encode_map(CUtensorMap* out, const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  thread_local MapSlot slots[kMapSlots];
  thread_local int next = 0;
  MapKey key;
  memset(&key, 0, sizeof key);
  key.base = base, key.rank = rank, key.type = static_cast<int>(type), key.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) key.dims[i] = dims[i], key.box[i] = box[i];
  for (int i = 0; i + 1 < rank; ++i) key.strides[i] = strides[i];
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
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  MapSlot& slot = slots[next];
  const CUresult r = encode(&slot.map, type, rank, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    slot.used = false;
    fprintf(stderr, "drin: cuTensorMapEncodeTiled failed (%d) for base %p, rank %d, dims (%llu, %llu, %llu, %llu)\n",
            static_cast<int>(r), base, rank, (unsigned long long)dims[0], (unsigned long long)dims[1],
            (unsigned long long)(rank > 2 ? dims[2] : 0), (unsigned long long)(rank > 3 ? dims[3] : 0));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slot.key = key;
  slot.used = true;
  next = (next + 1) % kMapSlots;
  *out = slot.map;
  return 0;
}

// the map of a row-major [rows, cols] bf16 matrix read in [64, 64] boxes
// (128-byte swizzle), or of a float32 one read in [64 rows, 16 columns]
// boxes (64-byte swizzle)
template <typename T>
inline int matrix_map(CUtensorMap* out, const void* base, int rows, int cols) {
  constexpr bool f32 = sizeof(T) == 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {f32 ? 16u : 64u, 64};
  return encode_map(out, base, 2, dims, strides, box,
                    f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    f32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
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
