// Fused softmax attention, backward, for Hopper (sm_90a).
//
// Replaces the two backward kernels of drin_tpu/ops/pallas/attention.py:
// _attn_bwd_kernel (with the additive mask and its cotangent) and
// _attn_bwd_kernel_nomask.  Given q, k, v [B, H, L, Dh], the mask [B, L], the
// forward's output o and the gradient dO, with P = softmax(q.k^T * s + mask):
//   dV = P^T . dO
//   dS = P * (dO . V^T - delta),  delta = rowsum(P * dO.V^T) = rowsum(dO * o)
//   dQ = s * dS . K,   dK = s * dS^T . Q,   dmask[b, h, key] = sum over rows of dS
// The [L, L] tiles never reach device memory in either direction.
//
// What bounds it on the H100: at [96, 12, 512, 64] bf16 the five products are
// 193 GFLOP (0.195 ms at the tensor cores' peak) over ~0.6 GB of q, k, v, o,
// dO, dq, dk and dv (0.18 ms): as in the forward both limits are close, and
// the exponentials of the recomputed P weigh as much as a product.
//
// The TPU kernel gives one (b, h) to one instance with three [L, L] f32 tiles
// (~3 MB) in fast memory and recomputes the exact row softmax.  That does not
// fit 227 KB of shared memory, and blocks here run in no order with nothing
// carried between them.  So:
//   * the forward kernel also stores the row max m and the row sum l
//     ([B, H, L] f32 each, kept apart: for a row whose keys are all dropped
//     m + log l would round back to m), so P = exp(S - m) / l needs no second
//     softmax pass;
//   * two launches, no atomics, the same result from run to run:
//       dq kernel   one block per (b, h, kDqWG * 64 query rows): loops over
//                   key tiles, owns dQ, and stores each query's m (base 2), 1 / l
//                   and delta for the second launch, in tiles of 64 queries padded
//                   with (m = +inf, 0, 0) so that a query past L recomputes to
//                   P = 0 without a test;
//       dkv kernel  one block per (b, h, kDqWG * 64 keys): loops over query
//                   tiles (Q, dO and the three statistics of 64 queries ride
//                   in one ring stage), works on the transposed tile
//                   S^T = K . Q^T so that its warps own keys, and owns dK, dV
//                   and the column sums of dS (dmask of that (b, h); the
//                   wrapper adds the heads);
//     both recompute S and P, so seven products run for a function of five;
//   * bf16: the forward's building blocks.  One elected thread keeps a ring
//     of tiles in flight by TMA (mbarriers count the bytes that land and the
//     warps that are done); every product is wgmma.  For S and dP the tensor
//     cores read both operands from shared memory: the block's own rows (q
//     and dO, or k and v, loaded once) as A and the streamed tile K-major as
//     B, which leaves the registers to the accumulators.  P and dS leave the
//     accumulators as A operands of dQ, dK and dV without touching shared
//     memory and are rounded to bf16 there (the TPU kernel keeps them f32);
//     their B is the streamed tile again, MN-major, as it lies;
//     f32: the same two-launch form with every product on wgmma in
//     split-precision TF32 (its section below), nothing rounded.
// Keys past L (ragged last tile) get -inf logits and so P = 0; query rows past
// L arrive as zero q and dO.  The mask keeps its magnitude, so an all-dropped
// row recomputes to the uniform P = 1 / L.  Like the forward, both kernels
// take the exponent in base 2 (fill_mask_log2 in attention_common.cuh: one
// FFMA, one FADD, one ex2 per logit) and cut it off at 0, because the stored
// natural-unit m comes back into base 2 one rounding away from the forward's
// (row_max_log2 there); the dq kernel also leaves 1 / l out of dS and scales
// its finished rows by it instead.
// The mask-free instantiation reads no mask and stores no dmask.

#include "attention_common.cuh"

// The compiled-in tile configuration (tools/attention_sweep.py builds the
// others with -D and times them side by side).
#ifndef DRIN_ATTN_DQ_WG
#define DRIN_ATTN_DQ_WG 2        // dq kernel: warpgroups = 64-row query tiles per block
#endif
#ifndef DRIN_ATTN_DQ_STAGES
#define DRIN_ATTN_DQ_STAGES 3    // dq kernel: (K, V) tiles in the ring
#endif
#ifndef DRIN_ATTN_DQ_BLOCKS
#define DRIN_ATTN_DQ_BLOCKS 2    // dq kernel: blocks per SM the register budget is cut for
#endif
#ifndef DRIN_ATTN_DKV_WG
#define DRIN_ATTN_DKV_WG 1       // dkv kernel: warpgroups = 64-key tiles per block
#endif
#ifndef DRIN_ATTN_DKV_STAGES
#define DRIN_ATTN_DKV_STAGES 3   // dkv kernel: (Q, dO, statistics) tiles in the ring
#endif
#ifndef DRIN_ATTN_DKV_BLOCKS
#define DRIN_ATTN_DKV_BLOCKS 3   // dkv kernel: blocks per SM the register budget is cut for
#endif

namespace {

// ------------------------------------------------------------------ bf16
// delta of one row: each thread of a quad sums 16 of the 64 columns of
// dO * o (two 16-byte loads of each), the quad adds up
__device__ __forceinline__ float row_dot64(const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b, int t) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + t * 16 + i * 8);
    const uint4 y = *reinterpret_cast<const uint4*>(b + t * 16 + i * 8);
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[w]));
      const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&yw[w]));
      acc += fx.x * fy.x + fx.y * fy.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

constexpr int kBwdKT = 64;                          // keys (dq) or queries (dkv) per streamed tile
constexpr int kStatTile = 3 * 64;                   // m, 1 / l, delta of 64 queries (floats)

// dq kernel, shared memory: q | dO | ring of (K, V) | mask row | barriers
constexpr int kDqWG = DRIN_ATTN_DQ_WG, kDqStages = DRIN_ATTN_DQ_STAGES;
constexpr int kDqRows = kDqWG * 64;                 // query rows a block owns
constexpr int kDqThreads = kDqWG * kWgThreads;
constexpr int kDqStageBytes = 2 * kTile64;
constexpr int kDqOffDo = kDqRows * kRowBytes;
constexpr int kDqOffRing = 2 * kDqRows * kRowBytes;
constexpr int kDqOffMask = kDqOffRing + kDqStages * kDqStageBytes;
constexpr int kDqOffBars = kDqOffMask + kMaxL * 4;
constexpr int kDqSmem = 1024 + kDqOffBars + (1 + 2 * kDqStages) * 8;
// dkv kernel: k | v | ring of (Q, dO, statistics) | barriers
constexpr int kDkvWG = DRIN_ATTN_DKV_WG, kDkvStages = DRIN_ATTN_DKV_STAGES;
constexpr int kDkvRows = kDkvWG * 64;               // keys a block owns
constexpr int kDkvThreads = kDkvWG * kWgThreads;
constexpr int kDkvStageBytes = 2 * kTile64 + 1024;  // the statistics take 768 of the last 1024
constexpr int kDkvStageTx = 2 * kTile64 + kStatTile * 4;
constexpr int kDkvOffV = kDkvRows * kRowBytes;
constexpr int kDkvOffRing = 2 * kDkvRows * kRowBytes;
constexpr int kDkvOffBars = kDkvOffRing + kDkvStages * kDkvStageBytes;
constexpr int kDkvSmem = 1024 + kDkvOffBars + (1 + 2 * kDkvStages) * 8;
static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "shared memory of one block");

// grid: B * H * ceil(L / kDqRows) blocks.  dq is [B, L, H, 64] contiguous;
// stats [B * H, ceil(L / 64), 3, 64] f32 is written for the dkv kernel.
__global__ void __launch_bounds__(kDqThreads, DRIN_ATTN_DQ_BLOCKS)
attn_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const __nv_bfloat16* __restrict__ mask, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                 Strides os, Strides ds, long long mask_sb, int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t q_s = smem_u32(smem), do_s = q_s + kDqOffDo, ring = q_s + kDqOffRing,
                 bars = q_s + kDqOffBars;
  float* mask_s = reinterpret_cast<float*>(smem + kDqOffMask);
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };
  auto empty = [&](int s) { return bars + 8 + (kDqStages + s) * 8; };

  const int n_qt = (L + kDqRows - 1) / kDqRows;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kDqRows;
  const int n_kt = (L + kBwdKT - 1) / kBwdKT;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDqWG * 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: the (K, V) tile kt into its stage, once every warp has read what was there
  auto produce = [&](int kt) {
    const int s = kt % kDqStages, use = kt / kDqStages;
    if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
    mbar_expect_tx(full(s), kDqStageBytes);
    tma_load_tile(ring + s * kDqStageBytes, &tm_k, full(s), kt * kBwdKT, h, b);
    tma_load_tile(ring + s * kDqStageBytes + kTile64, &tm_v, full(s), kt * kBwdKT, h, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own_full, 2 * kDqRows * kRowBytes);
    for (int w = 0; w < kDqWG; ++w) {
      tma_load_tile(q_s + w * kTile64, &tm_q, own_full, q0 + w * 64, h, b);
      tma_load_tile(do_s + w * kTile64, &tm_do, own_full, q0 + w * 64, h, b);
    }
    for (int kt = 0; kt < kDqStages && kt < n_kt; ++kt) produce(kt);
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63, its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;  // fragment coordinates
  fill_mask_log2(mask_s, mask, mask_sb, b, L, threadIdx.x, kDqThreads);
  const float scale2 = scale * kLog2e;
  // per row: the forward's max (base 2) and 1 / sum, and delta = rowsum(dO * o)
  float m_row[2], il_row[2], dl_row[2];
  const int tile64 = qt * kDqWG + wg, n_t64 = (L + 63) / 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wq * 16 + g + r * 8, row = q0 + wg * 64 + lr;
    const bool in = row < L;  // the same for the four threads of a quad
    const size_t at = (size_t)bh * L + (in ? row : 0);
    m_row[r] = in ? row_max_log2(m_in[at]) : 0.f;
    il_row[r] = in ? 1.f / l_in[at] : 0.f;
    const size_t rr = in ? row : 0;
    dl_row[r] = row_dot64(dout + (size_t)b * ds.b + (size_t)h * ds.h + rr * ds.l,
                          o + (size_t)b * os.b + (size_t)h * os.h + rr * os.l, t);
    if (!in) dl_row[r] = 0.f;
    if (t == 0 && tile64 < n_t64) {
      float* st = stats + ((size_t)bh * n_t64 + tile64) * kStatTile + lr;
      st[0] = in ? m_row[r] : CUDART_INF_F;
      st[64] = il_row[r];
      st[128] = dl_row[r];
    }
  }
  mbar_wait(own_full, 0);
  const uint32_t qf = q_s + wg * kTile64, dof = do_s + wg * kTile64;  // read in place by the tensor cores
  __syncthreads();  // the mask row is written

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kDqStages;
    const uint32_t k_s = ring + st * kDqStageBytes, v_s = k_s + kTile64;
    mbar_wait(full(st), (kt / kDqStages) & 1);

    // s = q . k^T and dp = dO . v^T for 64 rows x kBwdKT keys
    float s[kBwdKT / 8][4], dp[kBwdKT / 8][4];
    wgmma_fence();
    mma_rows_of(s, qf, k_s);
    mma_rows_of(dp, dof, v_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // l * ds = e * (dp - delta), e = exp(logit - m) = l * p, left in s: 1 / l is a factor
    // of the whole row and is applied once, to the finished dq
#pragma unroll
    for (int j = 0; j < kBwdKT / 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&mask_s[kt * kBwdKT + j * 8 + t * 2]);
      const float p0 = exp2_le1(fmaf(s[j][0], scale2, mk.x) - m_row[0]);
      const float p1 = exp2_le1(fmaf(s[j][1], scale2, mk.y) - m_row[0]);
      const float p2 = exp2_le1(fmaf(s[j][2], scale2, mk.x) - m_row[1]);
      const float p3 = exp2_le1(fmaf(s[j][3], scale2, mk.y) - m_row[1]);
      s[j][0] = p0 * (dp[j][0] - dl_row[0]);
      s[j][1] = p1 * (dp[j][1] - dl_row[0]);
      s[j][2] = p2 * (dp[j][2] - dl_row[1]);
      s[j][3] = p3 * (dp[j][3] - dl_row[1]);
    }
    // dq * l += round(l * ds) . k
    uint32_t a[kBwdKT / 16][4];
    pack_a(a, s);
    wgmma_fence();
    mma_over_rows(acc, a, k_s, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    // refill the stage of the tile before: the other warps have had a whole tile to leave it
    if (threadIdx.x == 0 && kt >= 1 && kt - 1 + kDqStages < n_kt) produce(kt - 1 + kDqStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + wq * 16 + g + r * 8;
    if (row >= L) continue;
    __nv_bfloat16* dst = dq + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * (scale * il_row[r]), acc[j][2 * r + 1] * (scale * il_row[r]));
  }
}

// grid: B * H * ceil(L / kDkvRows) blocks, one per kDkvRows keys.  dk, dv are
// [B, L, H, 64] contiguous; dmask [B, H, L] f32 (kMask only, may be null).
template <bool kMask>
__global__ void __launch_bounds__(kDkvThreads, DRIN_ATTN_DKV_BLOCKS)
attn_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                  const __nv_bfloat16* __restrict__ mask, const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  float* __restrict__ dmask, long long mask_sb, int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t k_s = smem_u32(smem), v_s = k_s + kDkvOffV, ring = k_s + kDkvOffRing,
                 bars = k_s + kDkvOffBars;
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };
  auto empty = [&](int s) { return bars + 8 + (kDkvStages + s) * 8; };

  const int n_kb = (L + kDkvRows - 1) / kDkvRows;
  const int kb = blockIdx.x % n_kb, bh = blockIdx.x / n_kb;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kb * kDkvRows;
  const int n_qt = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDkvWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: Q, dO and the statistics of query tile qt into their stage, once it is free
  auto produce = [&](int qt) {
    const int s = qt % kDkvStages, use = qt / kDkvStages;
    if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
    const uint32_t at = ring + s * kDkvStageBytes;
    mbar_expect_tx(full(s), kDkvStageTx);
    tma_load_tile(at, &tm_q, full(s), qt * 64, h, b);
    tma_load_tile(at + kTile64, &tm_do, full(s), qt * 64, h, b);
    bulk_load(at + 2 * kTile64, stats + ((size_t)bh * n_qt + qt) * kStatTile, kStatTile * 4, full(s));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own_full, 2 * kDkvRows * kRowBytes);
    for (int w = 0; w < kDkvWG; ++w) {
      tma_load_tile(k_s + w * kTile64, &tm_k, own_full, k0 + w * 64, h, b);
      tma_load_tile(v_s + w * kTile64, &tm_v, own_full, k0 + w * 64, h, b);
    }
    for (int qt = 0; qt < kDkvStages && qt < n_qt; ++qt) produce(qt);
  }

  // warpgroup wg owns keys k0 + 64 wg .. + 63, its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;
  // the additive mask of this thread's keys (rows g and g + 8) in the base-2 form; -inf past L
  const float scale2 = scale * kLog2e;
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wg * 64 + wq * 16 + g + r * 8;
    mk[r] = key < L ? (kMask ? fmaxf(to_f(mask[(size_t)b * mask_sb + key]) * kLog2e, -kFltMax) : 0.f)
                    : -CUDART_INF_F;
  }
  mbar_wait(own_full, 0);
  const uint32_t kf = k_s + wg * kTile64, vf = v_s + wg * kTile64;  // read in place by the tensor cores

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  float dm_acc[2] = {0.f, 0.f};  // this thread's share of the column sums of dS

  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt % kDkvStages;
    const uint32_t q_s = ring + st * kDkvStageBytes, do_s = q_s + kTile64;
    const float* stat_s = reinterpret_cast<const float*>(smem + kDkvOffRing + st * kDkvStageBytes + 2 * kTile64);
    mbar_wait(full(st), (qt / kDkvStages) & 1);

    // the transposed tiles: st = k . q^T, dpt = v . dO^T, 64 keys x 64 queries
    float sT[8][4], dpT[8][4];
    wgmma_fence();
    mma_rows_of(sT, kf, q_s);
    mma_rows_of(dpT, vf, do_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sT);
    fence_acc(dpT);
    // p^T into sT, ds^T into dpT; the queries are the columns here
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = j * 8 + t * 2;
      const float2 mq = *reinterpret_cast<const float2*>(&stat_s[qa]);
      const float2 iq = *reinterpret_cast<const float2*>(&stat_s[64 + qa]);
      const float2 dq_ = *reinterpret_cast<const float2*>(&stat_s[128 + qa]);
      sT[j][0] = exp2_le1(fmaf(sT[j][0], scale2, mk[0]) - mq.x) * iq.x;
      sT[j][1] = exp2_le1(fmaf(sT[j][1], scale2, mk[0]) - mq.y) * iq.y;
      sT[j][2] = exp2_le1(fmaf(sT[j][2], scale2, mk[1]) - mq.x) * iq.x;
      sT[j][3] = exp2_le1(fmaf(sT[j][3], scale2, mk[1]) - mq.y) * iq.y;
      dpT[j][0] = sT[j][0] * (dpT[j][0] - dq_.x);
      dpT[j][1] = sT[j][1] * (dpT[j][1] - dq_.y);
      dpT[j][2] = sT[j][2] * (dpT[j][2] - dq_.x);
      dpT[j][3] = sT[j][3] * (dpT[j][3] - dq_.y);
      dm_acc[0] += dpT[j][0] + dpT[j][1];
      dm_acc[1] += dpT[j][2] + dpT[j][3];
    }
    // dv += round(p^T) . dO,  dk += round(ds^T) . q  (sums over the tile's queries)
    uint32_t pa[4][4], sa[4][4];
    pack_a(pa, sT);
    pack_a(sa, dpT);
    wgmma_fence();
    mma_over_rows(dv_acc, pa, do_s, 1);
    mma_over_rows(dk_acc, sa, q_s, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    if (threadIdx.x == 0 && qt >= 1 && qt - 1 + kDkvStages < n_qt) produce(qt - 1 + kDkvStages);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kMask) {  // all 32 lanes take part in the shuffles
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 1);
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 2);
    }
    const int key = k0 + wg * 64 + wq * 16 + g + r * 8;
    if (key >= L) continue;
    if (kMask && dmask && t == 0) dmask[(size_t)bh * L + key] = dm_acc[r];
    const size_t at = (((size_t)b * L + key) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------- f32
// The float32 kernels: the bf16 kernels' two-launch form, every product on
// wgmma in split-precision TF32 (attention_common.cuh's f32 section: three
// TF32 products per product, nothing rounded to a narrower type).  .tf32
// reads B only K-major, so a product that sums over a tile's rows (dQ over
// keys, dK and dV over queries) takes a transposed split copy of the tile
// (transpose_split, its rows in the order split_frags hands the
// accumulator's columns over).  The streamed tile is split by all threads of
// the block once it lands, hi written over the raw tile and lo beside it,
// under the previous tile's last product; its transposed copy is written
// while the tensor cores take the first product(s), which read only the
// natural tiles.  A [64, 64] f32 tile is 16 KB, so shared memory and
// registers decide the shapes (ptxas: 222 registers for dq, 187-191 for dkv,
// no spills; one block per SM each):
//   dq kernel   one block per (b, h, 128 query rows): two warpgroups share
//               each key tile's split (K hi / V hi over the raw stage, K lo,
//               V lo, K^T hi / lo: 96 KB); q's hi and lo are A fragments in
//               registers, dO's hi and lo A tiles in shared memory (A from
//               registers for both would take 128 registers a thread beside
//               three accumulators); S and dP in turns (mma_split2); 2 raw
//               stages; 195 KB.
//   dkv kernel  one block per (b, h, 64 keys), two warpgroups on the same
//               keys: one takes S^T and dV += P^T.dO, the other dP^T and dK
//               += dS^T.q, with P^T handed over through shared memory, so
//               that each keeps one operand (K, or V) as register fragments
//               and two accumulators; each query tile's split takes 128 KB
//               (Q hi / dO hi over the raw stage, Q lo, dO lo, Q^T and dO^T
//               hi / lo), beside the P^T tile and 3 raw stages; 211 KB.
// The softmax is recomputed in natural units from the forward's m and l,
// p = 2^((logit - m) * log2 e) / l, as the f32 forward takes it (no cut-off:
// the forward stores its own max).  The dq kernel stores each query's m,
// 1 / l and delta in tiles of 64 (m = +inf, 1 / l = 0 past L, so that a
// query past L recomputes to P = 0) for the dkv kernel, as the bf16 kernels do.
// Bound at [96, 12, 512, 64]: 3 x 193.3 GFLOP of TF32 products (1.171 ms at
// 495 TFLOP/s) over 1.21 GB (0.36 ms); the FMA route's bound is 2.885 ms.
constexpr int kF32DqWG = 2;                         // warpgroups = 64-row query tiles per block
constexpr int kF32DqRows = kF32DqWG * 64;
constexpr int kF32DqThreads = kF32DqWG * kWgThreads;
constexpr int kF32DqStages = 2;                      // raw (K, V) tiles in flight
constexpr int kF32DkvStages = 3;                     // raw (Q, dO) tiles in flight
constexpr int kF32DkvThreads = 2 * kWgThreads;
constexpr int kF32StageBytes = 2 * kF32Tile;         // (K, V) or (Q, dO) raw, hi written over them
// dq kernel: dO hi[WG] | dO lo[WG] | ring | K lo | V lo | K^T hi | K^T lo | mask row | barriers
// (q's raw tiles lie in the split area until the first tile's barrier)
constexpr int kF32DqOffRing = 2 * kF32DqWG * kF32Tile;
constexpr int kF32DqOffSplit = kF32DqOffRing + kF32DqStages * kF32StageBytes;
constexpr int kF32DqOffMask = kF32DqOffSplit + 4 * kF32Tile;
constexpr int kF32DqOffBars = kF32DqOffMask + kMaxL * 4;
constexpr int kF32DqSmem = 1024 + kF32DqOffBars + (1 + kF32DqStages) * 8;
// dkv kernel: ring | Q lo | dO lo | Q^T hi | Q^T lo | dO^T hi | dO^T lo | P | statistics of each
// stage | barriers (K's and V's raw tiles lie in the Q^T area until the first tile's barrier)
constexpr int kF32DkvOffSplit = kF32DkvStages * kF32StageBytes;
constexpr int kF32DkvOffP = kF32DkvOffSplit + 6 * kF32Tile;
constexpr int kF32DkvOffStats = kF32DkvOffP + kF32Tile;
constexpr int kF32DkvOffBars = kF32DkvOffStats + kF32DkvStages * kStatTile * 4;
constexpr int kF32DkvSmem = 1024 + kF32DkvOffBars + (1 + kF32DkvStages) * 8;
static_assert(kF32DqWG * kF32Tile <= 4 * kF32Tile, "q's raw tiles fit in the split area");
static_assert(kF32DqSmem <= 232448 && kF32DkvSmem <= 232448, "shared memory of one block");

// delta of one f32 row: each thread of a quad sums 16 of the 64 columns of dO * o
__device__ __forceinline__ float row_dot64(const float* __restrict__ a, const float* __restrict__ b, int t) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(a + t * 16 + i * 4);
    const float4 y = *reinterpret_cast<const float4*>(b + t * 16 + i * 4);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// grid: B * H * ceil(L / kF32DqRows) blocks.  dq is [B, L, H, 64] contiguous;
// stats [B * H, ceil(L / 64), 3, 64] f32 is written for the dkv kernel.
__global__ void __launch_bounds__(kF32DqThreads, 1)
attn_bwd_dq_f32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ mask, const float* __restrict__ o, const float* __restrict__ dout,
                const float* __restrict__ m_in, const float* __restrict__ l_in, float* __restrict__ dq,
                float* __restrict__ stats, Strides os, Strides ds, long long mask_sb, int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* split_p = smem + kF32DqOffSplit;
  const uint32_t base = smem_u32(smem), ring = base + kF32DqOffRing, split = base + kF32DqOffSplit,
                 bars = base + kF32DqOffBars;
  float* mask_s = reinterpret_cast<float*>(smem + kF32DqOffMask);
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };

  const int n_qt = (L + kF32DqRows - 1) / kF32DqRows;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kF32DqRows;
  const int n_kt = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kF32DqStages; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: the raw (K, V) tile kt into its stage, two boxes of 32 columns each
  auto produce = [&](int kt) {
    const int s = kt % kF32DqStages;
    const uint32_t st = ring + s * kF32StageBytes;
    mbar_expect_tx(full(s), kF32StageBytes);
    for (int x = 0; x < 2; ++x) {
      tma_load_tile(st + x * kF32Atom, &tm_k, full(s), kt * 64, h, b, x * 32);
      tma_load_tile(st + kF32Tile + x * kF32Atom, &tm_v, full(s), kt * 64, h, b, x * 32);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own_full, 2 * kF32DqWG * kF32Tile);
    for (int w = 0; w < kF32DqWG; ++w)
      for (int x = 0; x < 2; ++x) {
        tma_load_tile(base + w * kF32Tile + x * kF32Atom, &tm_do, own_full, q0 + w * 64, h, b, x * 32);
        tma_load_tile(split + w * kF32Tile + x * kF32Atom, &tm_q, own_full, q0 + w * 64, h, b, x * 32);
      }
    for (int kt = 0; kt < kF32DqStages && kt < n_kt; ++kt) produce(kt);
  }

  // warpgroup wg owns query rows q0 + 64 wg .. + 63, its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane / 4, t = lane % 4;  // fragment coordinates
  fill_mask<float, kF32DqThreads>(mask_s, mask, mask_sb, b, L);
  // per row: the forward's max and 1 / sum, and delta = rowsum(dO * o)
  float m_row[2], il_row[2], dl_row[2];
  const int tile64 = qt * kF32DqWG + wg, n_t64 = (L + 63) / 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wq * 16 + g + r * 8, row = q0 + wg * 64 + lr;
    const bool in = row < L;  // the same for the four threads of a quad
    const size_t at = (size_t)bh * L + (in ? row : 0), rr = in ? row : 0;
    m_row[r] = in ? m_in[at] : CUDART_INF_F;
    il_row[r] = in ? 1.f / l_in[at] : 0.f;
    dl_row[r] = row_dot64(dout + (size_t)b * ds.b + (size_t)h * ds.h + rr * ds.l,
                          o + (size_t)b * os.b + (size_t)h * os.h + rr * os.l, t);
    if (!in) dl_row[r] = 0.f;
    if (t == 0 && tile64 < n_t64) {
      float* st = stats + ((size_t)bh * n_t64 + tile64) * kStatTile + lr;
      st[0] = m_row[r];
      st[64] = il_row[r];
      st[128] = dl_row[r];
    }
  }
  mbar_wait(own_full, 0);
  split_in_place<kF32DqThreads>(smem, smem + kF32DqWG * kF32Tile, kF32DqWG);  // dO of every warpgroup
  uint32_t qhi[8][4], qlo[8][4];
  load_split_frags(qhi, qlo, split_p + wg * kF32Tile, wq * 16, lane);
  __syncthreads();  // q's raw tiles are read

  // all threads: key tile kt's K and V -> hi in place, K lo | V lo in the split area
  auto split_tile = [&](int kt) {
    const int st = kt % kF32DqStages;
    mbar_wait(full(st), (kt / kF32DqStages) & 1);
    split_in_place<kF32DqThreads>(smem + kF32DqOffRing + st * kF32StageBytes, split_p, 2);
    fence_proxy_async();  // the tensor cores read what the threads wrote
  };
  split_tile(0);

  const uint32_t dohi = base + wg * kF32Tile, dolo = base + (kF32DqWG + wg) * kF32Tile;
  const uint32_t klo = split, vlo = split + kF32Tile, kthi = split + 2 * kF32Tile, ktlo = split + 3 * kF32Tile;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kF32DqStages;
    const uint32_t k_s = ring + st * kF32StageBytes, v_s = k_s + kF32Tile;
    unsigned char* k_p = smem + kF32DqOffRing + st * kF32StageBytes;
    __syncthreads();  // tile kt is split (dO too, before tile 0); tile kt - 1's dq product is done

    // s = q . k^T and dp = dO . v^T for 64 rows x 64 keys
    float s[8][4], dp[8][4];
    wgmma_fence();
    mma_split2(s, qhi, qlo, k_s, klo, dp, dohi, dolo, v_s, vlo, 0);
    wgmma_commit();
    // while the tensor cores take them: K^T for the third product
    transpose_split<kF32DqThreads>(split_p + 2 * kF32Tile, split_p + 3 * kF32Tile, k_p, split_p, threadIdx.x);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // ds = p * (dp - delta), p = exp(logit - m) / l
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(&mask_s[kt * 64 + j * 8 + t * 2]);
      const float p0 = ex2((fmaf(s[j][0], scale, mk.x) - m_row[0]) * kLog2e) * il_row[0];
      const float p1 = ex2((fmaf(s[j][1], scale, mk.y) - m_row[0]) * kLog2e) * il_row[0];
      const float p2 = ex2((fmaf(s[j][2], scale, mk.x) - m_row[1]) * kLog2e) * il_row[1];
      const float p3 = ex2((fmaf(s[j][3], scale, mk.y) - m_row[1]) * kLog2e) * il_row[1];
      s[j][0] = p0 * (dp[j][0] - dl_row[0]);
      s[j][1] = p1 * (dp[j][1] - dl_row[0]);
      s[j][2] = p2 * (dp[j][2] - dl_row[1]);
      s[j][3] = p3 * (dp[j][3] - dl_row[1]);
    }
    uint32_t dshi[8][4], dslo[8][4];
    split_frags(dshi, dslo, s);
    fence_frags(dshi);
    fence_frags(dslo);
    __syncthreads();  // K^T is written; every warp is done with the stage and with K lo, V lo
    if (threadIdx.x == 0 && kt + kF32DqStages < n_kt) produce(kt + kF32DqStages);
    // dq += ds . k
    wgmma_fence();
    mma_split(acc, dshi, dslo, kthi, ktlo, 1);
    wgmma_commit();
    if (kt + 1 < n_kt) split_tile(kt + 1);  // while the tensor cores take it
    wgmma_wait<0>();
    fence_acc(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + wq * 16 + g + r * 8;
    if (row >= L) continue;
    float* dst = dq + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// grid: B * H * ceil(L / 64) blocks, one per 64 keys, two warpgroups on the
// same keys: warpgroup 0 takes S^T = k.q^T, P^T and dV += P^T.dO, warpgroup 1
// dP^T = v.dO^T, dS^T and dK += dS^T.q, and P^T goes from one to the other
// through shared memory (each thread's 32 values where its partner in the
// other warpgroup reads them).  Each warpgroup keeps its own operand (K, or
// V) as split A fragments in registers.  dk, dv are [B, L, H, 64] contiguous;
// dmask [B, H, L] f32 (kMask only, may be null).
template <bool kMask>
__global__ void __launch_bounds__(kF32DkvThreads, 1)
attn_bwd_dkv_f32(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ mask, const float* __restrict__ stats, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dmask, long long mask_sb, int H, int L,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* split_p = smem + kF32DkvOffSplit;
  float* p_s = reinterpret_cast<float*>(smem + kF32DkvOffP);
  const uint32_t ring = smem_u32(smem), split = ring + kF32DkvOffSplit, bars = ring + kF32DkvOffBars;
  const uint32_t own_full = bars;
  auto full = [&](int s) { return bars + 8 + s * 8; };

  const int n_kb = (L + 63) / 64;
  const int kb = blockIdx.x % n_kb, bh = blockIdx.x / n_kb;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wq = warp % 4, wtid = threadIdx.x % kWgThreads;
  const int k0 = kb * 64;
  const int n_qt = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kF32DkvStages; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // one thread: raw Q and dO of query tile qt and their statistics into its stage
  auto produce = [&](int qt) {
    const int s = qt % kF32DkvStages;
    const uint32_t at = ring + s * kF32StageBytes;
    mbar_expect_tx(full(s), kF32StageBytes + kStatTile * 4);
    for (int x = 0; x < 2; ++x) {
      tma_load_tile(at + x * kF32Atom, &tm_q, full(s), qt * 64, h, b, x * 32);
      tma_load_tile(at + kF32Tile + x * kF32Atom, &tm_do, full(s), qt * 64, h, b, x * 32);
    }
    bulk_load(ring + kF32DkvOffStats + s * kStatTile * 4, stats + ((size_t)bh * n_qt + qt) * kStatTile,
              kStatTile * 4, full(s));
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own_full, 2 * kF32Tile);
    for (int x = 0; x < 2; ++x) {
      tma_load_tile(split + 2 * kF32Tile + x * kF32Atom, &tm_k, own_full, k0, h, b, x * 32);
      tma_load_tile(split + 3 * kF32Tile + x * kF32Atom, &tm_v, own_full, k0, h, b, x * 32);
    }
    for (int qt = 0; qt < kF32DkvStages && qt < n_qt; ++qt) produce(qt);
  }

  // warp wq of each warpgroup owns keys k0 + 16 wq .. + 15
  const int g = lane / 4, t = lane % 4;
  // the additive mask of this thread's keys (rows g and g + 8); -inf past L
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wq * 16 + g + r * 8;
    mk[r] = key < L ? (kMask ? mask[(size_t)b * mask_sb + key] : 0.f) : -CUDART_INF_F;
  }
  mbar_wait(own_full, 0);
  uint32_t ahi[8][4], alo[8][4];  // warpgroup 0: K's fragments, warpgroup 1: V's
  load_split_frags(ahi, alo, split_p + (2 + wg) * kF32Tile, wq * 16, lane);

  // all threads: query tile qt's Q and dO -> hi in place, Q lo | dO lo in the split area
  auto split_tile = [&](int qt) {
    const int st = qt % kF32DkvStages;
    mbar_wait(full(st), (qt / kF32DkvStages) & 1);
    split_in_place<kF32DkvThreads>(smem + st * kF32StageBytes, split_p, 2);
    fence_proxy_async();  // the tensor cores read what the threads wrote
  };
  split_tile(0);

  // shared memory of each product: warpgroup 0 reads Q (hi in the stage, lo
  // in the split area) and dO^T, warpgroup 1 dO and Q^T
  const uint32_t lo1 = split + wg * kF32Tile, thi = split + (4 - 2 * wg) * kF32Tile, tlo = thi + kF32Tile;
  float acc[8][4];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dm_acc[2] = {0.f, 0.f};  // warpgroup 1: this thread's share of the column sums of dS

  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt % kF32DkvStages;
    const uint32_t hi1 = ring + st * kF32StageBytes + wg * kF32Tile;
    const unsigned char* q_p = smem + st * kF32StageBytes;
    const float* stat_s = reinterpret_cast<const float*>(smem + kF32DkvOffStats + st * kStatTile * 4);
    __syncthreads();  // tile qt is split (K's and V's raw tiles read, before tile 0); tile qt - 1 is done

    // s^T = k . q^T (warpgroup 0) or dp^T = v . dO^T (warpgroup 1), 64 keys x 64 queries
    float s1[8][4];
    wgmma_fence();
    mma_split(s1, ahi, alo, hi1, lo1, 0);
    wgmma_commit();
    // while the tensor cores take it: the transposed tile this warpgroup's
    // second product reads (dO^T for warpgroup 0, Q^T for warpgroup 1)
    transpose_split<kWgThreads>(smem + kF32DkvOffSplit + (4 - 2 * wg) * kF32Tile,
                                smem + kF32DkvOffSplit + (5 - 2 * wg) * kF32Tile, q_p + (1 - wg) * kF32Tile,
                                split_p + (1 - wg) * kF32Tile, wtid);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc(s1);
    // the queries are the columns here
    if (wg == 0) {  // p^T, handed to warpgroup 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qa = j * 8 + t * 2;
        const float2 mq = *reinterpret_cast<const float2*>(&stat_s[qa]);
        const float2 iq = *reinterpret_cast<const float2*>(&stat_s[64 + qa]);
        s1[j][0] = ex2((fmaf(s1[j][0], scale, mk[0]) - mq.x) * kLog2e) * iq.x;
        s1[j][1] = ex2((fmaf(s1[j][1], scale, mk[0]) - mq.y) * kLog2e) * iq.y;
        s1[j][2] = ex2((fmaf(s1[j][2], scale, mk[1]) - mq.x) * kLog2e) * iq.x;
        s1[j][3] = ex2((fmaf(s1[j][3], scale, mk[1]) - mq.y) * kLog2e) * iq.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) p_s[(j * 4 + i) * kWgThreads + wtid] = s1[j][i];
      }
      named_sync(1, kF32DkvThreads);
    } else {  // ds^T = p^T * (dp^T - delta), and its column sums
      float2 dl[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) dl[j] = *reinterpret_cast<const float2*>(&stat_s[128 + j * 8 + t * 2]);
      named_sync(1, kF32DkvThreads);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j][0] = p_s[(j * 4 + 0) * kWgThreads + wtid] * (s1[j][0] - dl[j].x);
        s1[j][1] = p_s[(j * 4 + 1) * kWgThreads + wtid] * (s1[j][1] - dl[j].y);
        s1[j][2] = p_s[(j * 4 + 2) * kWgThreads + wtid] * (s1[j][2] - dl[j].x);
        s1[j][3] = p_s[(j * 4 + 3) * kWgThreads + wtid] * (s1[j][3] - dl[j].y);
        dm_acc[0] += s1[j][0] + s1[j][1];
        dm_acc[1] += s1[j][2] + s1[j][3];
      }
    }
    // past barrier 1 both warpgroups are done with the stage (its tiles and
    // statistics) and with Q lo, dO lo: the stage is refilled, and the next
    // tile is split under this tile's second product
    if (threadIdx.x == 0 && qt + kF32DkvStages < n_qt) produce(qt + kF32DkvStages);
    uint32_t fhi[8][4], flo[8][4];
    split_frags(fhi, flo, s1);
    fence_frags(fhi);
    fence_frags(flo);
    named_sync(2 + wg, kWgThreads);  // this warpgroup's transposed tile is written
    // dv += p^T . dO (warpgroup 0) or dk += ds^T . q (warpgroup 1): sums over the tile's queries
    wgmma_fence();
    mma_split(acc, fhi, flo, thi, tlo, 1);
    wgmma_commit();
    if (qt + 1 < n_qt) split_tile(qt + 1);
    wgmma_wait<0>();
    fence_acc(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kMask && wg == 1) {  // all 32 lanes of the warp take part in the shuffles
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 1);
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 2);
    }
    const int key = k0 + wq * 16 + g + r * 8;
    if (key >= L) continue;
    if (kMask && wg == 1 && dmask && t == 0) dmask[(size_t)bh * L + key] = dm_acc[r];
    float* dst = (wg ? dk : dv) + (((size_t)b * L + key) * H + h) * kDh + t * 2;
    const float f = wg ? scale : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8) = make_float2(acc[j][2 * r] * f, acc[j][2 * r + 1] * f);
  }
}

struct BwdArgs {
  int dtype, B, H, L, Dh;
  const void *q, *k, *v, *mask, *o, *dout, *m, *l;
  void *dq, *dk, *dv, *dmask, *delta;
  Strides qs, ks, vs, os, ds;
  long long mask_sb;
  cudaStream_t stream;
};

template <bool kMask>
int launch_bwd(const BwdArgs& a) {
  if (a.B < 1 || a.H < 1 || a.L < 1 || a.L > kMaxL || a.Dh != kDh)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 0.125f;  // 64^-1/2
  const float* m = static_cast<const float*>(a.m);
  const float* l = static_cast<const float*>(a.l);
  float* delta = static_cast<float*>(a.delta);
  float* dmask = static_cast<float*>(a.dmask);
  auto grid = [&](int rows) { return (unsigned)((long long)a.B * a.H * ((a.L + rows - 1) / rows)); };
  if ((long long)a.B * a.H * ((a.L + 63) / 64) > 0x7fffffffLL)  // the largest of the grids
    return static_cast<int>(cudaErrorInvalidValue);
  const int eb = a.dtype == DT_FLOAT32 ? 4 : 2;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;  // every tensor is read in tiles of 64 rows
  int err = tile_map(&tm_q, a.q, a.qs, a.B, a.H, a.L, 64, eb);
  if (!err) err = tile_map(&tm_do, a.dout, a.ds, a.B, a.H, a.L, 64, eb);
  if (!err) err = tile_map(&tm_k, a.k, a.ks, a.B, a.H, a.L, 64, eb);
  if (!err) err = tile_map(&tm_v, a.v, a.vs, a.B, a.H, a.L, 64, eb);
  if (err) return err;
  if (a.dtype == DT_BFLOAT16) {
    using T = __nv_bfloat16;
    static const cudaError_t opted_dq = allow_smem(attn_bwd_dq_bf16, kDqSmem);
    static const cudaError_t opted_dkv = allow_smem(attn_bwd_dkv_bf16<kMask>, kDkvSmem);
    if (opted_dq != cudaSuccess) return static_cast<int>(opted_dq);
    if (opted_dkv != cudaSuccess) return static_cast<int>(opted_dkv);
    attn_bwd_dq_bf16<<<grid(kDqRows), kDqThreads, kDqSmem, a.stream>>>(
        tm_q, tm_do, tm_k, tm_v, static_cast<const T*>(a.mask), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), m, l, static_cast<T*>(a.dq), delta, a.os, a.ds, a.mask_sb, a.H, a.L,
        scale);
    cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    attn_bwd_dkv_bf16<kMask><<<grid(kDkvRows), kDkvThreads, kDkvSmem, a.stream>>>(
        tm_k, tm_v, tm_q, tm_do, static_cast<const T*>(a.mask), delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), dmask, a.mask_sb, a.H, a.L, scale);
  } else if (a.dtype == DT_FLOAT32) {
    using T = float;
    static const cudaError_t opted_dq = allow_smem(attn_bwd_dq_f32, kF32DqSmem);
    static const cudaError_t opted_dkv = allow_smem(attn_bwd_dkv_f32<kMask>, kF32DkvSmem);
    if (opted_dq != cudaSuccess) return static_cast<int>(opted_dq);
    if (opted_dkv != cudaSuccess) return static_cast<int>(opted_dkv);
    attn_bwd_dq_f32<<<grid(kF32DqRows), kF32DqThreads, kF32DqSmem, a.stream>>>(
        tm_q, tm_do, tm_k, tm_v, static_cast<const T*>(a.mask), static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), m, l, static_cast<T*>(a.dq), delta, a.os, a.ds, a.mask_sb, a.H, a.L,
        scale);
    cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    attn_bwd_dkv_f32<kMask><<<grid(64), kF32DkvThreads, kF32DkvSmem, a.stream>>>(
        tm_k, tm_v, tm_q, tm_do, static_cast<const T*>(a.mask), delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), dmask, a.mask_sb, a.H, a.L, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout: [B, H, L, 64] through their element strides for B, H and L
// (`strides`: 15 values, q k v o dout by (B, H, L); the last dimension
// contiguous, every row 16-byte aligned); m, l: [B, H, L] f32 from the forward;
// mask: [B, L] in the compute type with row stride mask_sb.  Outputs: dq, dk,
// dv [B, L, H, 64] contiguous (a view [B, H, L, 64] of each is the gradient);
// dmask [B, H, L] f32 or null when the mask needs no gradient; delta is
// workspace of B * H * ceil(L / 64) * 192 floats (each query's m, 1 / l and
// delta in tiles of 64 queries: m in base 2 for the bf16 kernels, natural
// units for the f32 ones).
DRIN_EXPORT int drin_attention_bwd(int dtype, int B, int H, int L, int Dh, const void* q,
                                   const void* k, const void* v, const void* mask, const void* o,
                                   const void* dout, const void* m, const void* l, void* dq, void* dk,
                                   void* dv, void* dmask, void* delta, const long long* strides,
                                   long long mask_sb, void* stream) {
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const BwdArgs a{dtype, B, H, L, Dh, q, k, v, mask, o, dout, m, l, dq, dk, dv, dmask, delta,
                  Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
                  Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]}, mask_sb,
                  static_cast<cudaStream_t>(stream)};
  return launch_bwd<true>(a);
}

// The same without a mask: no mask input, no dmask output.
DRIN_EXPORT int drin_attention_bwd_nomask(int dtype, int B, int H, int L, int Dh, const void* q,
                                          const void* k, const void* v, const void* o,
                                          const void* dout, const void* m, const void* l, void* dq,
                                          void* dk, void* dv, void* delta, const long long* strides,
                                          void* stream) {
  const long long* s = strides;
  const BwdArgs a{dtype, B, H, L, Dh, q, k, v, nullptr, o, dout, m, l, dq, dk, dv, nullptr, delta,
                  Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]}, Strides{s[6], s[7], s[8]},
                  Strides{s[9], s[10], s[11]}, Strides{s[12], s[13], s[14]}, 0,
                  static_cast<cudaStream_t>(stream)};
  return launch_bwd<false>(a);
}

// blocks that share one SM: 0 the bf16 dq kernel, 1 the dkv kernel with a mask, 2 without
DRIN_EXPORT int drin_attention_bwd_blocks_per_sm(int which) {
  if (which == 0) return blocks_per_sm(attn_bwd_dq_bf16, kDqThreads, kDqSmem);
  if (which == 1) return blocks_per_sm(attn_bwd_dkv_bf16<true>, kDkvThreads, kDkvSmem);
  return blocks_per_sm(attn_bwd_dkv_bf16<false>, kDkvThreads, kDkvSmem);
}
