// Fused softmax attention, forward, for Hopper (sm_90a).
//
// Replaces drin_tpu/ops/pallas/attention.py::fused_attention (forward body
// _attn_kernel): out = softmax(q.k^T * Dh^-1/2 + mask) . v for q, k, v
// [B, H, L, Dh] and an additive mask [B, L] that broadcasts over heads and
// query rows (0 keeps a key, finfo.min drops it; a null pointer means no
// mask).  The [L, L] logits never reach device memory.
//
// What bounds it on the H100: at [96, 12, 512, 64] bf16 the two products are
// 77 GFLOP (0.078 ms at the tensor cores' peak) over 302 MB of q, k, v and o
// traffic (0.090 ms), and the 302 M exponentials take about 0.08 ms of the
// special-function units, so three limits lie close together: the products
// have to run at wgmma's rate, the exponentials have to run under them and
// not between them, and K and V must not be fetched more often than needed.
// The TPU kernel keeps all of K and V of one (b, h) and a [block_q, L] f32
// logits tile in fast memory and takes the exact row softmax; here such a
// tile does not fit in registers, so the bf16 kernel streams:
//   * one block per (b, h, kFwdWG * 64 query rows): kFwdWG warpgroups of 64
//     rows each;
//   * one elected thread keeps a ring of kFwdStages (K, V) tiles of 64
//     keys in flight by TMA: a stage's "full" mbarrier counts the bytes that
//     land, its "empty" mbarrier the warps that are done with it, and the
//     thread refills the stage that was read one tile ago, so it hardly ever
//     waits; no block-wide barrier inside the loop.  (A producer warp of its
//     own costs a whole warpgroup's registers here: the compiler cuts a block
//     of 288 threads down as if it had 384.);
//   * both products are wgmma (bf16 in, f32 accumulators) with A from
//     registers: q's fragments are loaded once per block, p is the logits'
//     accumulator fragment rounded to bf16, and the tensor cores read K
//     (K-major) and V (MN-major, as it lies) from the swizzled tiles;
//   * while one warpgroup's products run, the other warpgroups (of this
//     block and of the next one on the SM) take their exponentials.  Measured
//     on the card, that overlap is partial: a tile's two products and its
//     softmax are one dependent chain per warpgroup, and with both compiled
//     out the loads, barriers and stores alone take over half of the kernel's
//     time.  Turns between the warpgroups, a grid of resident blocks walking
//     through the work, wider tiles and wider blocks were each built and
//     measured slower than this plain form;
//   * running row max and row sum in registers, the accumulator rescaled per
//     key tile, one division at the end.
// Same function as the TPU kernel within rounding; the one difference: p is
// rounded to bf16 before the normalisation (exp(logit - running max), in
// (0, 1]) rather than after it.
//
// The mask keeps its magnitude (about -3.4e38, finite), so all masked logits
// of a row are equal and a row with every key masked gets the uniform softmax
// of the reference.  The softmax is taken in base 2 (fill_mask_log2 in
// attention_common.cuh): one FFMA, one FADD and one ex2 per logit, with the
// mask cut off at -FLT_MAX so that mask * log2 e cannot overflow.  Keys past
// L (the ragged last tile; TMA delivers zeros for them) get -inf; the running
// max is finite from the first tile on (key 0 is always in range), so
// (-inf) - (-inf) never forms.
//
// The f32 kernel has the same streaming form with both products on wgmma in
// split-precision TF32 (three TF32 products per product, float32 accuracy;
// see its section below).
//
// Where a gradient will be asked for, both kernels also store the row max m
// and the row sum l of exp(logit - m), [B, H, L] f32 each, in natural units
// (the bf16 kernel's m a float step or two below its own max where the
// conversion from base 2 asks for it, natural_row_max in attention_common.cuh;
// the f32 kernel takes its softmax in natural units and stores its own max):
// the backward (attention_bwd.cu) recomputes P = exp(S - m) / l from them.
// Inference passes null pointers and stores nothing.

#include "attention_common.cuh"

// The compiled-in tile configurations (tools/attention_sweep.py builds the
// others with -D and times them side by side).
#ifndef DRIN_ATTN_FWD_STAGES
#define DRIN_ATTN_FWD_STAGES 4   // (K, V) tiles in the ring
#endif
#ifndef DRIN_ATTN_FWD_WG
#define DRIN_ATTN_FWD_WG 2       // warpgroups = 64-row query tiles per block
#endif
#ifndef DRIN_ATTN_FWD_BLOCKS
#define DRIN_ATTN_FWD_BLOCKS 2   // blocks per SM the register budget is cut for
#endif
// the f32 kernel's
#ifndef DRIN_ATTN_F32_STAGES
#define DRIN_ATTN_F32_STAGES 3   // raw (K, V) tiles in the ring
#endif
#ifndef DRIN_ATTN_F32_WG
#define DRIN_ATTN_F32_WG 2       // warpgroups = 64-row query tiles per block (at most 3)
#endif

namespace {

constexpr int kFwdKT = 64;                                // keys per tile
constexpr int kFwdStages = DRIN_ATTN_FWD_STAGES;
constexpr int kFwdWG = DRIN_ATTN_FWD_WG;
constexpr int kFwdRows = kFwdWG * 64;                     // query rows per block
constexpr int kFwdThreads = kFwdWG * kWgThreads;
constexpr int kFwdTileBytes = kFwdKT * kRowBytes;         // one K or V tile
constexpr int kFwdStageBytes = 2 * kFwdTileBytes;
// shared memory: q | ring | mask row | barriers (q_full, full[], empty[])
constexpr int kFwdOffRing = kFwdRows * kRowBytes;
constexpr int kFwdOffMask = kFwdOffRing + kFwdStages * kFwdStageBytes;
constexpr int kFwdOffBars = kFwdOffMask + kMaxL * 4;
constexpr int kFwdSmem = 1024 + kFwdOffBars + (1 + 2 * kFwdStages) * 8;
static_assert(kFwdSmem <= 232448, "shared memory of one block");

// grid: B * H * ceil(L / kFwdRows) blocks, the query tiles of one (b, h)
// adjacent (their K and V then meet in L2); out is [B, L, H, 64] contiguous.
__global__ void __launch_bounds__(kFwdThreads, DRIN_ATTN_FWD_BLOCKS)
attn_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
              long long mask_sb, int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t q_s = smem_u32(smem), ring = q_s + kFwdOffRing, bars = q_s + kFwdOffBars;
  float* mask_s = reinterpret_cast<float*>(smem + kFwdOffMask);
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };
  auto empty = [&](int s) { return bars + 8 + (kFwdStages + s) * 8; };

  const int n_qt = (L + kFwdRows - 1) / kFwdRows;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kFwdRows;
  const int n_kt = (L + kFwdKT - 1) / kFwdKT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kFwdWG * 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: the (K, V) tile kt into its stage, once every warp has read what was there
  auto produce = [&](int kt) {
    const int s = kt % kFwdStages, use = kt / kFwdStages;
    if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
    mbar_expect_tx(full(s), kFwdStageBytes);
    tma_load_tile(ring + s * kFwdStageBytes, &tm_k, full(s), kt * kFwdKT, h, b);
    tma_load_tile(ring + s * kFwdStageBytes + kFwdTileBytes, &tm_v, full(s), kt * kFwdKT, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, kFwdRows * kRowBytes);
    for (int w = 0; w < kFwdWG; ++w) tma_load_tile(q_s + w * kTile64, &tm_q, q_full, q0 + w * 64, h, b);
    for (int kt = 0; kt < kFwdStages && kt < n_kt; ++kt) produce(kt);
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63, its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;  // fragment coordinates
  fill_mask_log2(mask_s, mask, mask_sb, b, L, threadIdx.x, kFwdThreads);
  const float scale2 = scale * kLog2e;
  mbar_wait(q_full, 0);
  uint32_t qf[4][4];
  load_a_frags(qf, q_s + wg * kTile64, wq * 16, lane);
  __syncthreads();  // the mask row is written

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8, base 2
  float l_run[2] = {0.f, 0.f};                       // this thread's share of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kFwdStages;
    const uint32_t k_s = ring + st * kFwdStageBytes, v_s = k_s + kFwdTileBytes;
    mbar_wait(full(st), (kt / kFwdStages) & 1);

    // s = q . k^T for 64 rows x kFwdKT keys
    float s[kFwdKT / 8][4];
    wgmma_fence();
    mma_rows_of(s, qf, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // logits, tile row max (the four lanes of a quad share a row)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kFwdKT / 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&mask_s[kt * kFwdKT + j * 8 + t * 2]);
      s[j][0] = fmaf(s[j][0], scale2, mk.x);
      s[j][1] = fmaf(s[j][1], scale2, mk.y);
      s[j][2] = fmaf(s[j][2], scale2, mk.x);
      s[j][3] = fmaf(s[j][3], scale2, mk.y);
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: tile 0 holds key 0
      alpha[r] = ex2(m_run[r] - m_new);            // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kFwdKT / 8; ++j) {
      s[j][0] = ex2(s[j][0] - m_run[0]);
      s[j][1] = ex2(s[j][1] - m_run[0]);
      s[j][2] = ex2(s[j][2] - m_run[1]);
      s[j][3] = ex2(s[j][3] - m_run[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // o += round(p) . v
    uint32_t pa[kFwdKT / 16][4];
    pack_a(pa, s);
    wgmma_fence();
    mma_over_rows(o, pa, v_s, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    // refill the stage of the tile before: the other warps have had a whole tile to leave it
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + kFwdStages < n_kt) produce(kt - 1 + kFwdStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + wq * 16 + g + r * 8;
    if (row >= L) continue;
    if (m_out && t == 0) {  // the softmax residuals of the backward: row max (natural units) and row sum
      m_out[(size_t)bh * L + row] = natural_row_max(m_run[r]);
      l_out[(size_t)bh * L + row] = l_run[r];
    }
    __nv_bfloat16* op = out + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

// ------------------------------------------------------------------- f32
// The float32 forward on the tensor cores in split precision (three TF32
// products per product, float32 accuracy: attention_common.cuh's f32
// section).
//   * one block per (b, h, kF32WG * 64 query rows), key tiles of 64, as the
//     bf16 kernel; a [64, 64] f32 tile is two 128-byte-swizzled atoms of 32
//     columns, each arriving by its own TMA box;
//   * q's hi and lo are A fragments in registers, formed once per block;
//   * each key tile is split once per block by all its threads into a
//     double-buffered split area: K's hi written over the raw tile where it
//     lies (B read K-major, the head dim contiguous) and K's lo beside it; V
//     transposed into V^T hi and lo, since .tf32 has no MN-major B.
//     Tile kt + 1 is split while the tensor cores take tile kt's first
//     product; one __syncthreads at the end of each tile hands the split on
//     to the products (tile kt's raw stage is refilled right after it, and
//     its split buffer is free for tile kt + 2);
//   * p goes from the logits' accumulator into the second product's A
//     fragment without a shuffle (split_frags), V^T's keys in the order 0 2 4
//     6 1 3 5 7 within each group of 8 (transpose_split; a sum over keys does
//     not depend on their order);
//   * the softmax in natural units: logit = q.k * scale + mask, the row max m
//     of those, p = 2^((logit - m) * log2 e).  m and l are stored as the f32
//     backward reads them (exp(logit - m) / l): a row whose keys are all
//     dropped has logits equal to the mask value, m the same, p = 1 each.
// Bound at [64, 12, 512, 64]: 3 x 51.5 GFLOP of TF32 products (0.312 ms at
// 495 TFLOP/s) over 403 MB (0.120 ms); the FMA route's bound was 0.769 ms.
constexpr int kF32KT = 64;                        // keys per tile
constexpr int kF32Stages = DRIN_ATTN_F32_STAGES;
constexpr int kF32WG = DRIN_ATTN_F32_WG;
constexpr int kF32Rows = kF32WG * 64;             // query rows per block
constexpr int kF32Threads = kF32WG * kWgThreads;
constexpr int kF32StageBytes = 2 * kF32Tile;      // raw K (its hi written over it) | raw V
constexpr int kF32SplitBytes = 3 * kF32Tile;      // K lo | V^T hi | V^T lo
// shared memory: ring | split buffers 0, 1 (q's tiles in 1 until the first
// tile's barrier) | mask row | barriers (q_full, full[])
constexpr int kF32OffSplit = kF32Stages * kF32StageBytes;
constexpr int kF32OffMask = kF32OffSplit + 2 * kF32SplitBytes;
constexpr int kF32OffBars = kF32OffMask + kMaxL * 4;
constexpr int kF32Smem = 1024 + kF32OffBars + (1 + kF32Stages) * 8;
static_assert(kF32WG * kF32Tile <= kF32SplitBytes, "q's tiles fit in split buffer 1");
static_assert(kF32Stages >= 2, "a tile's stage is refilled while the next one is read");
static_assert(kF32KT == kDh, "K, V and V^T tiles are [64, 64]: two atoms each");
static_assert(kF32Smem <= 232448, "shared memory of one block");

// grid: B * H * ceil(L / kF32Rows) blocks, the query tiles of one (b, h)
// adjacent; out is [B, L, H, 64] contiguous
__global__ void __launch_bounds__(kF32Threads, 1)
attn_fwd_f32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ mask,
             float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
             long long mask_sb, int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* split_p = smem + kF32OffSplit;
  const uint32_t ring = smem_u32(smem), split = ring + kF32OffSplit, bars = ring + kF32OffBars;
  float* mask_s = reinterpret_cast<float*>(smem + kF32OffMask);
  const uint32_t q_s = split + kF32SplitBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };

  const int n_qt = (L + kF32Rows - 1) / kF32Rows;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kF32Rows;
  const int n_kt = (L + kF32KT - 1) / kF32KT;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kF32Stages; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: the raw (K, V) tile kt into its stage, two boxes of 32 columns each
  auto produce = [&](int kt) {
    const int s = kt % kF32Stages;
    const uint32_t st = ring + s * kF32StageBytes;
    mbar_expect_tx(full(s), kF32StageBytes);
    for (int x = 0; x < 2; ++x) {
      tma_load_tile(st + x * kF32Atom, &tm_k, full(s), kt * kF32KT, h, b, x * 32);
      tma_load_tile(st + kF32Tile + x * kF32Atom, &tm_v, full(s), kt * kF32KT, h, b, x * 32);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, kF32WG * kF32Tile);
    for (int w = 0; w < kF32WG; ++w)
      for (int x = 0; x < 2; ++x)
        tma_load_tile(q_s + w * kF32Tile + x * kF32Atom, &tm_q, q_full, q0 + w * 64, h, b, x * 32);
    for (int kt = 0; kt < kF32Stages && kt < n_kt; ++kt) produce(kt);
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63, its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;  // fragment coordinates
  fill_mask<float, kF32Threads>(mask_s, mask, mask_sb, b, L);
  mbar_wait(q_full, 0);
  uint32_t qhi[8][4], qlo[8][4];  // A fragments of the 8 k-steps of 8 columns
  load_split_frags(qhi, qlo, split_p + kF32SplitBytes + wg * kF32Tile, wq * 16, lane);

  // all threads: tile kt's K hi over its raw tile and K lo beside it, V
  // split into V^T hi and lo, in split buffer kt % 2
  auto split_tile = [&](int kt) {
    const int st = kt % kF32Stages;
    unsigned char* k_p = smem + st * kF32StageBytes;
    const unsigned char* v_p = k_p + kF32Tile;
    unsigned char* klo_p = split_p + (kt & 1) * kF32SplitBytes;
    unsigned char* vhi_p = klo_p + kF32Tile;
    unsigned char* vlo_p = vhi_p + kF32Tile;
    mbar_wait(full(st), (kt / kF32Stages) & 1);
    split_in_place<kF32Threads>(k_p, klo_p, 1);
    transpose_split<kF32Threads, true>(vhi_p, vlo_p, v_p, nullptr, threadIdx.x);
    fence_proxy_async();  // the tensor cores read what the threads wrote
  };
  split_tile(0);
  __syncthreads();  // tile 0 is split, the mask row written, q's tiles (split buffer 1) read

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8, natural units
  float l_run[2] = {0.f, 0.f};                       // this thread's share of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t k_s = ring + (kt % kF32Stages) * kF32StageBytes;
    const uint32_t klo_s = split + (kt & 1) * kF32SplitBytes, vhi_s = klo_s + kF32Tile, vlo_s = vhi_s + kF32Tile;

    // s = q . k^T for 64 rows x 64 keys: 8 k-steps of 8 columns, three products each
    float s[8][4];
    wgmma_fence();
    mma_split(s, qhi, qlo, k_s, klo_s, 0);
    wgmma_commit();
    // while the tensor cores take them: the next tile's split (its buffer was
    // last read by the tile before this one, which every warp has finished)
    if (kt + 1 < n_kt) split_tile(kt + 1);
    wgmma_wait<0>();
    fence_acc(s);

    // logits, tile row max (the four lanes of a quad share a row)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&mask_s[kt * kF32KT + j * 8 + t * 2]);
      s[j][0] = fmaf(s[j][0], scale, mk.x);
      s[j][1] = fmaf(s[j][1], scale, mk.y);
      s[j][2] = fmaf(s[j][2], scale, mk.x);
      s[j][3] = fmaf(s[j][3], scale, mk.y);
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);      // finite: tile 0 holds key 0
      alpha[r] = ex2((m_run[r] - m_new) * kLog2e);     // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2((s[j][0] - m_run[0]) * kLog2e);
      s[j][1] = ex2((s[j][1] - m_run[0]) * kLog2e);
      s[j][2] = ex2((s[j][2] - m_run[1]) * kLog2e);
      s[j][3] = ex2((s[j][3] - m_run[1]) * kLog2e);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // p as A fragments: position t of k-step j is key 2t, position t + 4 key 2t + 1
    uint32_t phi[8][4], plo[8][4];
    split_frags(phi, plo, s);
    // o += p . v: 8 k-steps of 8 keys over the V^T tiles
    wgmma_fence();
    mma_split(o, phi, plo, vhi_s, vlo_s, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    __syncthreads();  // every warp is done with tile kt and has split tile kt + 1
    // refill tile kt's raw stage
    if (threadIdx.x == 0 && kt + kF32Stages < n_kt) produce(kt + kF32Stages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + wq * 16 + g + r * 8;
    if (row >= L) continue;
    if (m_out && t == 0) {  // the softmax residuals of the backward, natural units
      m_out[(size_t)bh * L + row] = m_run[r];
      l_out[(size_t)bh * L + row] = l_run[r];
    }
    float* op = out + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(op + j * 8) = make_float2(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

}  // namespace

// q, k, v: [B, H, L, 64] through their element strides for B, H and L (the
// last dimension contiguous, every row 16-byte aligned); mask: [B, L] in the
// compute type with row stride mask_sb, or null; out: [B, L, H, 64]
// contiguous, so that a view [B, H, L, 64] of it is the result and
// [B, L, H * 64] costs no copy.  m_out, l_out: [B, H, L] f32, the row max of
// the logits and the row sum of exp(logit - max), or both null (inference:
// nothing is stored).
DRIN_EXPORT int drin_attention_fwd(int dtype, int B, int H, int L, int Dh, const void* q,
                                   const void* k, const void* v, const void* mask, void* out,
                                   void* m_out, void* l_out, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                                   long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                                   long long v_sl, long long mask_sb, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  if ((m_out == nullptr) != (l_out == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_sl}, ks{k_sb, k_sh, k_sl}, vs{v_sb, v_sh, v_sl};
  const float scale = 0.125f;  // 64^-1/2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BFLOAT16) {
    const long long blocks = (long long)B * H * ((L + kFwdRows - 1) / kFwdRows);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tm_q, tm_k, tm_v;
    int err = tile_map(&tm_q, q, qs, B, H, L, 64);
    if (!err) err = tile_map(&tm_k, k, ks, B, H, L, kFwdKT);
    if (!err) err = tile_map(&tm_v, v, vs, B, H, L, kFwdKT);
    if (err) return err;
    static const cudaError_t opted = allow_smem(attn_fwd_bf16, kFwdSmem);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    attn_fwd_bf16<<<(unsigned)blocks, kFwdThreads, kFwdSmem, s>>>(
        tm_q, tm_k, tm_v, static_cast<const __nv_bfloat16*>(mask), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out), mask_sb, H, L, scale);
  } else if (dtype == DT_FLOAT32) {
    const long long blocks = (long long)B * H * ((L + kF32Rows - 1) / kF32Rows);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tm_q, tm_k, tm_v;
    int err = tile_map(&tm_q, q, qs, B, H, L, 64, 4);
    if (!err) err = tile_map(&tm_k, k, ks, B, H, L, kF32KT, 4);
    if (!err) err = tile_map(&tm_v, v, vs, B, H, L, kF32KT, 4);
    if (err) return err;
    static const cudaError_t opted = allow_smem(attn_fwd_f32, kF32Smem);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    attn_fwd_f32<<<(unsigned)blocks, kF32Threads, kF32Smem, s>>>(
        tm_q, tm_k, tm_v, static_cast<const float*>(mask), static_cast<float*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out), mask_sb, H, L, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks of the bf16 forward kernel that share one SM (for the sweep tool and the records)
DRIN_EXPORT int drin_attention_fwd_blocks_per_sm() {
  return blocks_per_sm(attn_fwd_bf16, kFwdThreads, kFwdSmem);
}

// the same for the f32 forward kernel
DRIN_EXPORT int drin_attention_fwd_f32_blocks_per_sm() {
  return blocks_per_sm(attn_fwd_f32, kF32Threads, kF32Smem);
}
