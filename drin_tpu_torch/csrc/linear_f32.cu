// Float32 linear y = epilogue(x . W^T + b) for Hopper (sm_90a): BERT's four
// products a layer in float32 (encoders/bert.py).
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (drin_tpu/encoders/bert.py), and the port left them to cuBLAS, whose
// float32 product runs on the FMA units (67 TFLOP/s on the H100).  Float32
// accuracy on the tensor cores takes three TF32 products (hopper.cuh's split
// precision: x = hi + lo, each rounded to TF32, lo.hi + hi.lo + hi.hi in f32
// accumulators), so the bound is 3 x 2MNK operations at 495 TFLOP/s: 165
// TFLOP/s float32-equivalent.  At BERT's shapes (M = 36,864 token rows, K and
// N 768-3,072) every product lies far above the card's ridge: the tensor
// cores and the bytes that feed them from L2 set the pace.  What the design
// does about it:
//   * W is split once, not once a block: linear_image_f32 writes W's hi and
//     lo image (the Python wrapper keeps it while the weights are unchanged),
//     laid out as the ring's stages so that a stage's W is two bulk copies,
//     in 128-byte-swizzled rows (wgmma's B layout, K-major), the columns of
//     each k-step of 8 in the order 0 2 4 6 1 3 5 7 so that a thread's two A
//     positions t and t + 4 are neighbouring columns of x.
//   * x is split in registers: a consumer loads its A fragments (one 8-byte
//     load a row a k-step, bank-conflict free through the row order below)
//     from the raw x tile that TMA landed, splits them and issues three wgmma
//     m64nNk8 a k-step (lo.hi, hi.lo, hi.hi, as wgmma_tf32_split), so x is
//     read from memory once, as float32.
//   * A block is persistent (one an SM) and warp-specialised: one producer
//     warp keeps TMA loads of x tiles and bulk copies of W's image in an
//     mbarrier ring; two consumer warpgroups own 64 rows each of a 128-row
//     tile, 128 or 64 columns wide (the wrapper picks 64 where 128 would
//     leave SMs idle: the mention pass, M = 1,024), accumulators in
//     registers (setmaxnreg moves the producer's registers to them).  The
//     tiles are walked with N fastest, so the blocks in flight share x rows in
//     L2 and W's image (at most 19 MB at BERT's widths) stays there.  The
//     producer fills the ring with the next tile's slices while the consumers
//     run the epilogue.
//   * The tensor cores round their float32 sums toward zero, an error that
//     grows with K (2.4e-5 of the largest output at K = 3,072, against 2.9e-6
//     for cuBLAS's float32 product on the FMA units): every kPromote stages
//     (128 columns of K) their sum is added into a second float32 sum in
//     registers, rounded to nearest, and they start again (1e-6 at every K,
//     for a few percent of the time).
//   * The epilogue is fused: the second sum starts at the residual (the
//     attention output and FFN output linears), loaded under the tile's first
//     products; the epilogue adds the bias, takes the exact erf gelu (the
//     FFN's first linear) or nothing and stores, so no separate launch reads
//     y again.

#include "hopper.cuh"

// 1: the products in one TF32 pass (hi.hi alone), a planted fault for the
// checks; 3 is the kernel
#ifndef DRIN_LINEAR_PASSES
#define DRIN_LINEAR_PASSES 3
#endif

namespace {

constexpr int kBM = 128;                     // rows of a tile: 64 a consumer warpgroup
constexpr int kImgCols = 128;                // W's image in blocks of 128 rows (output columns)
constexpr int kBK = 32;                      // K columns of a stage: one 128-byte swizzle row
constexpr int kRowB = kBK * 4;               // bytes of a tile row
constexpr int kXBytes = kBM * kRowB;         // the x tile of a stage, 16 KB
constexpr int kConsumerWarps = 8;            // two consumer warpgroups
constexpr int kThreads = 3 * kWgThreads;     // and the producer warpgroup
// registers a thread after setmaxnreg: the producer's warpgroup gives up what
// the consumers take (65,536 an SM: 128 x 40 + 256 x 232)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the stages between two promotions of the tensor cores' sum into the second
// sum: 128 columns of K
constexpr int kPromote = 128 / kBK;

enum Epi : int { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// kBN: output columns of a tile, 128 or 64
template <int kBN> struct Plan {
  static constexpr int kNJ = kBN / 8;                 // accumulator groups of 8 columns
  static constexpr int kWBytes = kBN * kRowB;         // W's hi (or lo) tile of a stage
  static constexpr int kStageBytes = kXBytes + 2 * kWBytes;
  static constexpr int kFit = (232448 - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kOffBars = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kOffBars + 2 * kStages * 8;
  static_assert(kBN == 128 || kBN == 64, "tiles of 128 or 64 columns");
  static_assert(kStages >= 3, "three stages in the ring at least");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct LinArgs {
  const float* img;   // W's split image [N / 128][K / 32][hi, lo][128][32] (linear_image_f32)
  const float* bias;  // [N]
  const float* res;   // EPI_RESIDUAL: [M, N] rows ldr apart
  float* y;           // output segment i (columns seg i .. seg (i + 1)): [M, seg] at y + i seg_stride, rows ldy apart
  long long ldr, ldy, seg_stride;
  int M, N, K, seg, epi;
};

__device__ __forceinline__ float gelu_erf(float x) { return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f)); }

template <int kNJ>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kNJ][4], const uint32_t (&a)[4], uint64_t desc, int keep) {
  if constexpr (kNJ == 16) wgmma_tf32_n128(d, a, desc, keep);
  else wgmma_tf32_n64(d, a, desc, keep);
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
linear_tf32x3(const __grid_constant__ CUtensorMap xmap, const LinArgs a) {
  using P = Plan<kBN>;
  constexpr int kNJ = P::kNJ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + P::kOffBars, empty = full + 8 * P::kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_n = a.N / kBN, n_k = a.K / kBK;
  const int tiles = (a.M + kBM - 1) / kBM * n_n;
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the last block-wide barrier: the producer's idle lanes leave after it

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mb = tile / n_n, n0 = tile % n_n * kBN;
        // the image block of these columns, from row n0 % 128 of its tiles
        const float* w = a.img + ((size_t)(n0 / kImgCols) * n_k * 2 * kImgCols + n0 % kImgCols) * kBK;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const int s = it % P::kStages;
          mbar_wait(empty + 8 * s, ((it / P::kStages) & 1) ^ 1);  // the first pass finds it free
          const uint32_t st = base + s * P::kStageBytes, bar = full + 8 * s;
          const float* hi = w + (size_t)ks * 2 * kImgCols * kBK;
          mbar_expect_tx(bar, P::kStageBytes);
          tma_load_2d(st, &xmap, bar, ks * kBK, mb * kBM);
          bulk_load(st + kXBytes, hi, P::kWBytes, bar);
          bulk_load(st + kXBytes + P::kWBytes, hi + kImgCols * kBK, P::kWBytes, bar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile, all its columns
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  // fragment row g reads tile row rg (+ 16 wq, + 8 for the second half): the
  // rows of one load phase then differ in bits 1-2 (lanes 0-15) or are odd
  // (16-31), so that their 8-byte loads of a 128-byte-swizzled row fall in
  // distinct banks; the epilogue writes each row where it was read
  const int rg = ((g & 3) << 1) | (g >> 2);
  const int r0 = wg * 64 + wq * 16 + rg;  // this thread's rows of the tile: r0, r0 + 8
  float acc[kNJ][4];  // each run of products starts it afresh (scale-d 0)
  float sum[kNJ][4];  // the promoted sum, from the residual (or 0) on
#pragma unroll
  for (int j = 0; j < kNJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  int it = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mb = tile / n_n, n0 = tile % n_n * kBN;
    // the second sum starts at the residual (or 0), loaded straight into it
    // under the tile's first products: nothing waits for it before the first
    // promotion, and the epilogue reads no rows
    const int col = n0 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mb * kBM + r0 + 8 * h;
      const bool load = a.epi == EPI_RESIDUAL && row < a.M;
      const float* r = a.res + (size_t)row * a.ldr + col;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float2 rr = load ? *reinterpret_cast<const float2*>(r + 8 * j) : make_float2(0.f, 0.f);
        sum[j][2 * h] = rr.x, sum[j][2 * h + 1] = rr.y;
      }
    }
    uint32_t fh[2][4], fl[2][4];
    int fresh = 1;  // the next products start the accumulators afresh
#pragma unroll 1
    for (int ks = 0; ks < n_k; ++ks, ++it) {
      const int s = it % P::kStages;
      const uint32_t st = base + s * P::kStageBytes;
      mbar_wait(full + 8 * s, (it / P::kStages) & 1);
      const unsigned char* xt = smem + s * P::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const int b = kk & 1;
        // positions t and t + 4 of k-step kk are columns 8 kk + 2t and + 1 of x
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          const float2 v = *reinterpret_cast<const float2*>(
              xt + row * kRowB + (((2 * kk + (t >> 1)) ^ (row & 7)) << 4) + (t & 1) * 8);
          float hi, lo;
          split_tf32(v.x, hi, lo);
          fh[b][h] = __float_as_uint(hi), fl[b][h] = __float_as_uint(lo);
          split_tf32(v.y, hi, lo);
          fh[b][2 + h] = __float_as_uint(hi), fl[b][2 + h] = __float_as_uint(lo);
        }
        fence_acc(acc);
        asm volatile("" : "+r"(fh[b][0]), "+r"(fh[b][1]), "+r"(fh[b][2]), "+r"(fh[b][3])::"memory");
        asm volatile("" : "+r"(fl[b][0]), "+r"(fl[b][1]), "+r"(fl[b][2]), "+r"(fl[b][3])::"memory");
        wgmma_fence();
        const uint32_t bhi = st + kXBytes + kk * 32, blo = bhi + P::kWBytes;
        const int keep = kk == 0 ? 1 - fresh : 1;
#if DRIN_LINEAR_PASSES == 3
        wgmma_tf32(acc, fl[b], tile_desc(bhi), keep);
        wgmma_tf32(acc, fh[b], tile_desc(blo), 1);
        wgmma_tf32(acc, fh[b], tile_desc(bhi), 1);
#else
        wgmma_tf32(acc, fh[b], tile_desc(bhi), keep);
#endif
        wgmma_commit();
        // the previous k-step's products are done: its fragments may be
        // written again, and at kk = 0 the previous stage is free
        wgmma_wait<1>();
        fence_acc(acc);
        if (kk == 0 && ks > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % P::kStages));
        }
      }
      fresh = 0;
      if ((ks + 1) % kPromote == 0 || ks + 1 == n_k) {
        // the run's sum into the second sum, rounded to nearest
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sum[j][i] += acc[j][i];
        fresh = 1;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % P::kStages));  // the tile's last stage

    // the epilogue, while the producer loads the next tile's first stages;
    // the tile lies in one output segment
    const int part = n0 / a.seg;
    float* ys = a.y + part * a.seg_stride + (col - part * a.seg);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mb * kBM + r0 + 8 * h;
      if (row >= a.M) continue;
      float* y = ys + (size_t)row * a.ldy;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + col + 8 * j));
        float v0 = sum[j][2 * h] + bb.x, v1 = sum[j][2 * h + 1] + bb.y;
        if (a.epi == EPI_GELU) v0 = gelu_erf(v0), v1 = gelu_erf(v1);
        *reinterpret_cast<float2*>(y + 8 * j) = make_float2(v0, v1);
      }
    }
  }
}

// W's split image: the matrices w[0..n) stacked by rows ([rows[i], K] each,
// row-major, N = their sum, a multiple of 128) as [N / 128][K / 32][hi,
// lo][128][32] f32, each [128][32] tile 128-byte swizzled (16-byte chunk c of
// row r at chunk c ^ (r % 8)), k-step j's 8 columns in the order 0 2 4 6 1 3
// 5 7.  A thread a 16-byte chunk of the hi tile and the same of the lo tile.
struct SplitArgs {
  const float* w[3];
  int rows[3];
};

__global__ void __launch_bounds__(256) linear_image_f32(const SplitArgs s, int N, int K, float* img) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)N * K / 4) return;
  const int pc = (int)(idx & 7);
  long long rest = idx >> 3;
  const int r = (int)(rest % kImgCols);
  rest /= kImgCols;
  const int n_k = K / kBK, ks = (int)(rest % n_k), nb = (int)(rest / n_k);
  int n = nb * kImgCols + r;
  // the matrix by selects, not by indexing the parameter (which copies it to the stack)
  const float* w = s.w[0];
  if (n >= s.rows[0]) {
    n -= s.rows[0];
    w = s.w[1];
    if (n >= s.rows[1]) n -= s.rows[1], w = s.w[2];
  }
  const int c = pc ^ (r & 7);  // the chunk of positions this physical chunk holds
  // positions 4 (c % 2) .. + 3 of k-step c / 2: columns 0 2 4 6 or 1 3 5 7 of it
  const float* src = w + (size_t)n * K + ks * kBK + (c >> 1) * 8 + (c & 1);
  const float4 x = make_float4(src[0], src[2], src[4], src[6]);
  float4 hi, lo;
  split_tf32(x, hi, lo);
  float* dst = img + (((size_t)nb * n_k + ks) * 2 * kImgCols + r) * kBK + pc * 4;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + kImgCols * kBK) = lo;
}

template <int kBN>
int launch(const CUtensorMap& xmap, const LinArgs& a, int grid, cudaStream_t stream) {
  constexpr int smem = Plan<kBN>::kSmem;
  static const cudaError_t opted = allow_smem(linear_tf32x3<kBN>, smem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  linear_tf32x3<kBN><<<grid, kThreads, smem, stream>>>(xmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W's split image from up to three matrices stacked by rows (w1, w2 may be
// null with rows 0): rows0 + rows1 + rows2 = N, a multiple of 128; K a
// multiple of 32; img holds 2 N K floats.
DRIN_EXPORT int drin_linear_image_f32(const void* w0, const void* w1, const void* w2, int rows0, int rows1,
                                      int rows2, int K, void* img, void* stream) {
  const long long N = (long long)rows0 + rows1 + rows2;
  if (rows0 < 1 || rows1 < 0 || rows2 < 0 || N % kImgCols || K < kBK || K % kBK || N * K > 0x7fffffffLL * 4 ||
      (rows1 && !w1) || (rows2 && !w2))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs s;
  s.w[0] = static_cast<const float*>(w0), s.w[1] = static_cast<const float*>(w1);
  s.w[2] = static_cast<const float*>(w2);
  s.rows[0] = rows0, s.rows[1] = rows1, s.rows[2] = rows2;
  const long long chunks = N * K / 4;
  linear_image_f32<<<(unsigned)((chunks + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, (int)N, K, static_cast<float*>(img));
  return static_cast<int>(cudaGetLastError());
}

// y = epilogue(x . W^T + b): x [M, K] float32, rows ldx floats apart (a
// multiple of 4, the base 16-byte aligned), img W's split image
// (drin_linear_image_f32), bias [N]; the output's columns in segments of seg
// (a multiple of 128 that divides N), segment i a [M, seg] matrix at y + i
// seg_stride with rows ldy apart (one segment: y [M, N]; the stacked query,
// key and value: three [M, 768] matrices, M 768 apart); epi 0 bias, 1 bias
// and exact-erf gelu, 2 bias and the residual res [M, N] (rows ldr apart,
// one segment only).  N a multiple of 128, K of 32.  cols: 128 or 64 columns
// a block tile; grid: the persistent blocks (at most one an SM).
DRIN_EXPORT int drin_linear_f32(const void* x, long long ldx, int M, int N, int K, const void* img,
                                const void* bias, const void* res, long long ldr, void* y, long long ldy,
                                int seg, long long seg_stride, int epi, int cols, int grid, void* stream) {
  if (M < 1 || N < kImgCols || N % kImgCols || K < kBK || K % kBK || ldx < K || ldx % 4 || seg < kImgCols ||
      seg % kImgCols || N % seg || ldy < seg || ldy % 2 || (N > seg && seg_stride < (long long)M * ldy) ||
      seg_stride % 2 || epi < EPI_BIAS || epi > EPI_RESIDUAL ||
      (epi == EPI_RESIDUAL && (!res || ldr < N || ldr % 2 || N > seg)) || (cols != 128 && cols != 64) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  int err = encode_map(&xmap, x, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err) return err;
  LinArgs a;
  a.img = static_cast<const float*>(img), a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res), a.y = static_cast<float*>(y);
  a.ldr = ldr, a.ldy = ldy, a.seg_stride = seg_stride, a.M = M, a.N = N, a.K = K, a.seg = seg, a.epi = epi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cols == 128 ? launch<128>(xmap, a, grid, s) : launch<64>(xmap, a, grid, s);
}

// dynamic shared memory of a block at 128 or 64 columns a tile; -1 for others
DRIN_EXPORT int drin_linear_smem(int cols) {
  return cols == 128 ? Plan<128>::kSmem : cols == 64 ? Plan<64>::kSmem : -1;
}
