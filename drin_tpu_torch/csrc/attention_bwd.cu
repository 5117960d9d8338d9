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
// dO, dq, dk and dv (0.18 ms): as in the forward both limits are close.
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
//       dq kernel   one block per (b, h, 64 query rows): loops over key tiles
//                   (K and V through shared memory, cp.async, double-buffered,
//                   the forward's form), owns dQ, and stores delta for the
//                   second launch;
//       dkv kernel  one block per (b, h, 64 keys): loops over query tiles
//                   (Q and dO through shared memory with their m, 1/l and
//                   delta), works on the transposed tile S^T = K . Q^T so that
//                   its warps own keys, and owns dK, dV and the column sums of
//                   dS (dmask of that (b, h); the wrapper adds the heads);
//     both recompute S and P;
//   * bf16: all products on the tensor cores (mma.sync m16n8k16, f32
//     accumulators); P and dS leave the accumulators as A operands without
//     touching shared memory and are rounded to bf16 there (the TPU kernel
//     keeps them f32); f32: plain-FMA kernels of the same two-launch form,
//     nothing rounded.
// Keys past L (ragged last tile) get -inf logits and so P = 0; query rows past
// L get m = 0, 1/l = 0 and zero q, dO, so they add nothing.  The mask keeps
// its magnitude, so an all-dropped row recomputes to the uniform P = 1 / L.
// The mask-free instantiation reads no mask and stores no dmask.

#include "attention_common.cuh"

namespace {

// delta for rows g and g + 8 of this warp's 16 query rows: each thread of a
// quad sums 16 of the 64 columns of dO * o, the quad adds up
template <typename T>
__device__ __forceinline__ float row_dot64(const T* __restrict__ a, const T* __restrict__ b, int t) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc += to_f(a[t * 16 + i]) * to_f(b[t * 16 + i]);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// ------------------------------------------------------------------ bf16
// grid: B * H * ceil(L / 64) blocks.  dq is [B, L, H, 64] contiguous; delta
// [B, H, L] f32 is written for the dkv kernel.
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ m_in, const float* __restrict__ l_in,
                 __nv_bfloat16* __restrict__ dq, float* __restrict__ delta_out, Strides qs, Strides ks,
                 Strides vs, Strides os, Strides ds, long long mask_sb, int H, int L, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBK][kRow];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBK][kRow];
  __shared__ float mask_s[kMaxL];

  const int n_qt = (L + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q0 = qt * kBQ;
  const __nv_bfloat16* qp = q + (size_t)b * qs.b + (size_t)h * qs.h;
  const __nv_bfloat16* kp = k + (size_t)b * ks.b + (size_t)h * ks.h;
  const __nv_bfloat16* vp = v + (size_t)b * vs.b + (size_t)h * vs.h;
  const __nv_bfloat16* op = o + (size_t)b * os.b + (size_t)h * os.h;
  const __nv_bfloat16* dop = dout + (size_t)b * ds.b + (size_t)h * ds.h;
  const int n_kt = (L + kBK - 1) / kBK;

  // the query tile and its dO are staged through the second K and V buffers
  load_tile(k_s[1], qp, qs.l, q0, L);
  load_tile(v_s[1], dop, ds.l, q0, L);
  cp_async_commit();
  load_tile(k_s[0], kp, ks.l, 0, L);
  load_tile(v_s[0], vp, vs.l, 0, L);
  cp_async_commit();
  fill_mask(mask_s, mask, mask_sb, b, L);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kDh / 16][4], dof[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int r0 = warp * 16 + g, c = kk * 16 + t * 2;
    qf[kk][0] = ld_u32(&k_s[1][r0][c]);
    qf[kk][1] = ld_u32(&k_s[1][r0 + 8][c]);
    qf[kk][2] = ld_u32(&k_s[1][r0][c + 8]);
    qf[kk][3] = ld_u32(&k_s[1][r0 + 8][c + 8]);
    dof[kk][0] = ld_u32(&v_s[1][r0][c]);
    dof[kk][1] = ld_u32(&v_s[1][r0 + 8][c]);
    dof[kk][2] = ld_u32(&v_s[1][r0][c + 8]);
    dof[kk][3] = ld_u32(&v_s[1][r0 + 8][c + 8]);
  }
  // per row: the forward's max and 1 / sum, and delta = rowsum(dO * o)
  float m_row[2], il_row[2], dl_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + r * 8, row = q0 + lr;
    const bool in = row < L;  // the same for the four threads of a quad
    const size_t at = (size_t)bh * L + (in ? row : 0);
    m_row[r] = in ? m_in[at] : 0.f;
    il_row[r] = in ? 1.f / l_in[at] : 0.f;
    dl_row[r] = row_dot64(&v_s[1][lr][0], op + (size_t)(in ? row : 0) * os.l, t);
    if (!in) dl_row[r] = 0.f;
    if (in && t == 0) delta_out[at] = dl_row[r];
  }
  __syncthreads();  // the staged tiles are read before tile 1 overwrites them

  float acc[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile(k_s[buf ^ 1], kp, ks.l, (kt + 1) * kBK, L);
      load_tile(v_s[buf ^ 1], vp, vs.l, (kt + 1) * kBK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // s = q . k^T and dp = dO . v^T for 16 rows x 64 keys
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[buf][j * 8 + g][kk * 16 + t * 2];
        const __nv_bfloat16* vr = &v_s[buf][j * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[j], qf[kk], ld_u32(kr), ld_u32(kr + 8));
        mma_bf16(dp[j], dof[kk], ld_u32(vr), ld_u32(vr + 8));
      }
    }
    // ds = p * (dp - delta), p = exp(logit - m) / l, left in s
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float m0 = mask_s[kt * kBK + j * 8 + t * 2], m1 = mask_s[kt * kBK + j * 8 + t * 2 + 1];
      const float p0 = __expf(s[j][0] * scale + m0 - m_row[0]) * il_row[0];
      const float p1 = __expf(s[j][1] * scale + m1 - m_row[0]) * il_row[0];
      const float p2 = __expf(s[j][2] * scale + m0 - m_row[1]) * il_row[1];
      const float p3 = __expf(s[j][3] * scale + m1 - m_row[1]) * il_row[1];
      s[j][0] = p0 * (dp[j][0] - dl_row[0]);
      s[j][1] = p1 * (dp[j][1] - dl_row[0]);
      s[j][2] = p2 * (dp[j][2] - dl_row[1]);
      s[j][3] = p3 * (dp[j][3] - dl_row[1]);
    }
    // dq += round(ds) . k
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDh / 8; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, k_s[buf], kk * 16, j * 8, lane);
        mma_bf16(acc[j], a, bfr[0], bfr[1]);
        mma_bf16(acc[j + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    __nv_bfloat16* dst = dq + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// grid: B * H * ceil(L / 64) blocks, one per key tile.  dk, dv are
// [B, L, H, 64] contiguous; dmask [B, H, L] f32 (kMask only, may be null).
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
                  const float* __restrict__ l_in, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  float* __restrict__ dmask, Strides qs, Strides ks, Strides vs, Strides ds,
                  long long mask_sb, int H, int L, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[2][kBQ][kRow];
  __shared__ __align__(16) __nv_bfloat16 do_s[2][kBQ][kRow];
  __shared__ float m_s[2][kBQ], il_s[2][kBQ], dl_s[2][kBQ];

  const int n_kt = (L + kBK - 1) / kBK;
  const int kt = blockIdx.x % n_kt, bh = blockIdx.x / n_kt;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = kt * kBK;
  const __nv_bfloat16* qp = q + (size_t)b * qs.b + (size_t)h * qs.h;
  const __nv_bfloat16* kp = k + (size_t)b * ks.b + (size_t)h * ks.h;
  const __nv_bfloat16* vp = v + (size_t)b * vs.b + (size_t)h * vs.h;
  const __nv_bfloat16* dop = dout + (size_t)b * ds.b + (size_t)h * ds.h;
  const int n_qt = (L + kBQ - 1) / kBQ;

  // per-query statistics of one query tile into buffer `buf`
  auto load_stats = [&](int buf, int r0) {
    if (threadIdx.x < kBQ) {
      const int row = r0 + threadIdx.x;
      const bool in = row < L;
      const size_t at = (size_t)bh * L + (in ? row : 0);
      m_s[buf][threadIdx.x] = in ? m_in[at] : 0.f;
      il_s[buf][threadIdx.x] = in ? 1.f / l_in[at] : 0.f;
      dl_s[buf][threadIdx.x] = in ? delta[at] : 0.f;
    }
  };

  // this block's K and V tile is staged through the second Q and dO buffers
  load_tile(q_s[1], kp, ks.l, k0, L);
  load_tile(do_s[1], vp, vs.l, k0, L);
  cp_async_commit();
  load_tile(q_s[0], qp, qs.l, 0, L);
  load_tile(do_s[0], dop, ds.l, 0, L);
  cp_async_commit();
  load_stats(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[kDh / 16][4], vf[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int r0 = warp * 16 + g, c = kk * 16 + t * 2;
    kf[kk][0] = ld_u32(&q_s[1][r0][c]);
    kf[kk][1] = ld_u32(&q_s[1][r0 + 8][c]);
    kf[kk][2] = ld_u32(&q_s[1][r0][c + 8]);
    kf[kk][3] = ld_u32(&q_s[1][r0 + 8][c + 8]);
    vf[kk][0] = ld_u32(&do_s[1][r0][c]);
    vf[kk][1] = ld_u32(&do_s[1][r0 + 8][c]);
    vf[kk][2] = ld_u32(&do_s[1][r0][c + 8]);
    vf[kk][3] = ld_u32(&do_s[1][r0 + 8][c + 8]);
  }
  // the additive mask of this thread's keys (rows g and g + 8); -inf past L
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + r * 8;
    mk[r] = key < L ? (kMask ? to_f(mask[(size_t)b * mask_sb + key]) : 0.f) : -CUDART_INF_F;
  }
  __syncthreads();  // the staged tiles are read before tile 1 overwrites them

  float dk_acc[kDh / 8][4], dv_acc[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  float dm_acc[2] = {0.f, 0.f};  // this thread's share of the column sums of dS

  for (int qt = 0; qt < n_qt; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < n_qt) {
      load_tile(q_s[buf ^ 1], qp, qs.l, (qt + 1) * kBQ, L);
      load_tile(do_s[buf ^ 1], dop, ds.l, (qt + 1) * kBQ, L);
      cp_async_commit();
      load_stats(buf ^ 1, (qt + 1) * kBQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the transposed tiles: st = k . q^T, dpt = v . dO^T, 16 keys x 64 queries
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const __nv_bfloat16* qr = &q_s[buf][j * 8 + g][kk * 16 + t * 2];
        const __nv_bfloat16* dr = &do_s[buf][j * 8 + g][kk * 16 + t * 2];
        mma_bf16(st[j], kf[kk], ld_u32(qr), ld_u32(qr + 8));
        mma_bf16(dpt[j], vf[kk], ld_u32(dr), ld_u32(dr + 8));
      }
    }
    // p^T into st, ds^T into dpt; the queries are the columns here
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int qa = j * 8 + t * 2, qb = qa + 1;
      const float ma = m_s[buf][qa], mb = m_s[buf][qb];
      const float ia = il_s[buf][qa], ib = il_s[buf][qb];
      const float da = dl_s[buf][qa], db = dl_s[buf][qb];
      st[j][0] = __expf(st[j][0] * scale + mk[0] - ma) * ia;
      st[j][1] = __expf(st[j][1] * scale + mk[0] - mb) * ib;
      st[j][2] = __expf(st[j][2] * scale + mk[1] - ma) * ia;
      st[j][3] = __expf(st[j][3] * scale + mk[1] - mb) * ib;
      dpt[j][0] = st[j][0] * (dpt[j][0] - da);
      dpt[j][1] = st[j][1] * (dpt[j][1] - db);
      dpt[j][2] = st[j][2] * (dpt[j][2] - da);
      dpt[j][3] = st[j][3] * (dpt[j][3] - db);
      dm_acc[0] += dpt[j][0] + dpt[j][1];
      dm_acc[1] += dpt[j][2] + dpt[j][3];
    }
    // dv += round(p^T) . dO,  dk += round(ds^T) . q  (sums over the tile's queries)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDh / 8; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, do_s[buf], kk * 16, j * 8, lane);
        mma_bf16(dv_acc[j], pa, bfr[0], bfr[1]);
        mma_bf16(dv_acc[j + 1], pa, bfr[2], bfr[3]);
        ldmatrix_x4_trans(bfr, q_s[buf], kk * 16, j * 8, lane);
        mma_bf16(dk_acc[j], sa, bfr[0], bfr[1]);
        mma_bf16(dk_acc[j + 1], sa, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kMask) {  // all 32 lanes take part in the shuffles
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 1);
      dm_acc[r] += __shfl_xor_sync(0xffffffffu, dm_acc[r], 2);
    }
    const int key = k0 + warp * 16 + g + r * 8;
    if (key >= L) continue;
    if (kMask && dmask && t == 0) dmask[(size_t)bh * L + key] = dm_acc[r];
    const size_t at = (((size_t)b * L + key) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------- f32
// Plain FMA, tiles of 32 rows x 32 rows, four threads per owned row (they
// share a warp): each computes 8 of the tile's 32 dots per product and then
// accumulates a quarter (16 columns) of the owned row's outputs.
constexpr int kGT = 32;          // rows per tile, both ways
constexpr int kGRow = kDh + 4;   // padded tile row (floats), rows stay 16-byte aligned

__device__ __forceinline__ void load_tile_f32(float (*tile)[kGRow], const float* __restrict__ src,
                                              long long stride_l, int r0, int L) {
  for (int c = threadIdx.x; c < kGT * kDh / 4; c += kThreads) {
    const int r = c / (kDh / 4), col = (c % (kDh / 4)) * 4;
    *reinterpret_cast<float4*>(&tile[r][col]) =
        r0 + r < L ? *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * stride_l + col)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) {
    const float4 x = a4[i], y = b4[i];
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  return acc;
}

// grid: B * H * ceil(L / 32) blocks, one per tile of 32 query rows
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ mask, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ m_in,
                const float* __restrict__ l_in, float* __restrict__ dq, float* __restrict__ delta_out,
                Strides qs, Strides ks, Strides vs, Strides os, Strides ds, long long mask_sb, int H,
                int L, float scale) {
  __shared__ __align__(16) float q_s[kGT][kGRow];
  __shared__ __align__(16) float do_s[kGT][kGRow];
  __shared__ __align__(16) float k_s[kGT][kGRow];
  __shared__ __align__(16) float v_s[kGT][kGRow];
  __shared__ float ds_s[kGT][kGT + 1];
  __shared__ float mask_s[kMaxL];

  const int n_qt = (L + kGT - 1) / kGT;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;  // owned row, quarter
  const int q0 = qt * kGT, row = q0 + r;
  const bool in = row < L;
  const float* kp = k + (size_t)b * ks.b + (size_t)h * ks.h;
  const float* vp = v + (size_t)b * vs.b + (size_t)h * vs.h;

  load_tile_f32(q_s, q + (size_t)b * qs.b + (size_t)h * qs.h, qs.l, q0, L);
  load_tile_f32(do_s, dout + (size_t)b * ds.b + (size_t)h * ds.h, ds.l, q0, L);
  fill_mask(mask_s, mask, mask_sb, b, L);
  __syncthreads();
  const size_t at = (size_t)bh * L + (in ? row : 0);
  const float m_row = in ? m_in[at] : 0.f, il_row = in ? 1.f / l_in[at] : 0.f;
  float dl_row = 0.f;
  if (in) {
    const float* orow = o + (size_t)b * os.b + (size_t)h * os.h + (size_t)row * os.l;
    for (int i = 0; i < kDh; ++i) dl_row += do_s[r][i] * orow[i];
    if (c == 0) delta_out[at] = dl_row;
  }

  float acc[kDh / 4];
#pragma unroll
  for (int d = 0; d < kDh / 4; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kGT) {
    __syncthreads();  // the previous tile is read
    load_tile_f32(k_s, kp, ks.l, k0, L);
    load_tile_f32(v_s, vp, vs.l, k0, L);
    __syncthreads();
    for (int kk = 0; kk < kGT / 4; ++kk) {
      const int key = kk * 4 + c;
      const float s = dot64(q_s[r], k_s[key]) * scale + mask_s[k0 + key];
      const float p = expf(s - m_row) * il_row;
      ds_s[r][key] = p * (dot64(do_s[r], v_s[key]) - dl_row);
    }
    __syncwarp();
    for (int key = 0; key < kGT; ++key) {
      const float dsv = ds_s[r][key];
      const float4* kr = reinterpret_cast<const float4*>(&k_s[key][c * (kDh / 4)]);
#pragma unroll
      for (int i = 0; i < kDh / 16; ++i) {
        const float4 kv = kr[i];
        acc[4 * i] += dsv * kv.x;
        acc[4 * i + 1] += dsv * kv.y;
        acc[4 * i + 2] += dsv * kv.z;
        acc[4 * i + 3] += dsv * kv.w;
      }
    }
    __syncwarp();  // ds_s of this row is read before the next tile rewrites it
  }
  if (in) {
    float4* dst = reinterpret_cast<float4*>(dq + (((size_t)b * L + row) * H + h) * kDh + c * (kDh / 4));
#pragma unroll
    for (int i = 0; i < kDh / 16; ++i)
      dst[i] = make_float4(acc[4 * i] * scale, acc[4 * i + 1] * scale, acc[4 * i + 2] * scale,
                           acc[4 * i + 3] * scale);
  }
}

// grid: B * H * ceil(L / 32) blocks, one per tile of 32 keys
template <bool kMask>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ mask, const float* __restrict__ dout,
                 const float* __restrict__ m_in, const float* __restrict__ l_in,
                 const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dmask, Strides qs, Strides ks, Strides vs, Strides ds,
                 long long mask_sb, int H, int L, float scale) {
  __shared__ __align__(16) float q_s[kGT][kGRow];
  __shared__ __align__(16) float do_s[kGT][kGRow];
  __shared__ __align__(16) float k_s[kGT][kGRow];
  __shared__ __align__(16) float v_s[kGT][kGRow];
  __shared__ float p_s[kGT][kGT + 1];
  __shared__ float ds_s[kGT][kGT + 1];
  __shared__ float m_s[kGT], il_s[kGT], dl_s[kGT];

  const int n_kt = (L + kGT - 1) / kGT;
  const int kt = blockIdx.x % n_kt, bh = blockIdx.x / n_kt;
  const int b = bh / H, h = bh % H;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;  // owned key, quarter
  const int k0 = kt * kGT, key = k0 + r;
  const bool in = key < L;
  const float* qp = q + (size_t)b * qs.b + (size_t)h * qs.h;
  const float* dop = dout + (size_t)b * ds.b + (size_t)h * ds.h;

  load_tile_f32(k_s, k + (size_t)b * ks.b + (size_t)h * ks.h, ks.l, k0, L);
  load_tile_f32(v_s, v + (size_t)b * vs.b + (size_t)h * vs.h, vs.l, k0, L);
  const float mk = in ? (kMask ? mask[(size_t)b * mask_sb + key] : 0.f) : -CUDART_INF_F;

  float dk_acc[kDh / 4], dv_acc[kDh / 4];
#pragma unroll
  for (int d = 0; d < kDh / 4; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  float dm_acc = 0.f;

  for (int q0 = 0; q0 < L; q0 += kGT) {
    __syncthreads();  // the previous tile is read
    load_tile_f32(q_s, qp, qs.l, q0, L);
    load_tile_f32(do_s, dop, ds.l, q0, L);
    if (threadIdx.x < kGT) {
      const int row = q0 + threadIdx.x;
      const bool rin = row < L;
      const size_t at = (size_t)bh * L + (rin ? row : 0);
      m_s[threadIdx.x] = rin ? m_in[at] : 0.f;
      il_s[threadIdx.x] = rin ? 1.f / l_in[at] : 0.f;
      dl_s[threadIdx.x] = rin ? delta[at] : 0.f;
    }
    __syncthreads();
    for (int qq = 0; qq < kGT / 4; ++qq) {
      const int qi = qq * 4 + c;
      const float s = dot64(k_s[r], q_s[qi]) * scale + mk;
      const float p = expf(s - m_s[qi]) * il_s[qi];
      const float dsv = p * (dot64(v_s[r], do_s[qi]) - dl_s[qi]);
      p_s[r][qi] = p;
      ds_s[r][qi] = dsv;
      dm_acc += dsv;
    }
    __syncwarp();
    for (int qi = 0; qi < kGT; ++qi) {
      const float p = p_s[r][qi], dsv = ds_s[r][qi];
      const float4* dr = reinterpret_cast<const float4*>(&do_s[qi][c * (kDh / 4)]);
      const float4* qr = reinterpret_cast<const float4*>(&q_s[qi][c * (kDh / 4)]);
#pragma unroll
      for (int i = 0; i < kDh / 16; ++i) {
        const float4 dv4 = dr[i], q4 = qr[i];
        dv_acc[4 * i] += p * dv4.x;
        dv_acc[4 * i + 1] += p * dv4.y;
        dv_acc[4 * i + 2] += p * dv4.z;
        dv_acc[4 * i + 3] += p * dv4.w;
        dk_acc[4 * i] += dsv * q4.x;
        dk_acc[4 * i + 1] += dsv * q4.y;
        dk_acc[4 * i + 2] += dsv * q4.z;
        dk_acc[4 * i + 3] += dsv * q4.w;
      }
    }
    __syncwarp();  // p_s, ds_s of this key are read before the next tile rewrites them
  }
  if (kMask) {  // the four threads of a key are neighbours in a warp
    dm_acc += __shfl_xor_sync(0xffffffffu, dm_acc, 1);
    dm_acc += __shfl_xor_sync(0xffffffffu, dm_acc, 2);
    if (in && dmask && c == 0) dmask[(size_t)bh * L + key] = dm_acc;
  }
  if (in) {
    const size_t at = (((size_t)b * L + key) * H + h) * kDh + c * (kDh / 4);
    float4* dkp = reinterpret_cast<float4*>(dk + at);
    float4* dvp = reinterpret_cast<float4*>(dv + at);
#pragma unroll
    for (int i = 0; i < kDh / 16; ++i) {
      dkp[i] = make_float4(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale, dk_acc[4 * i + 2] * scale,
                           dk_acc[4 * i + 3] * scale);
      dvp[i] = make_float4(dv_acc[4 * i], dv_acc[4 * i + 1], dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
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
  const int tile = a.dtype == DT_BFLOAT16 ? kBQ : kGT;
  const long long blocks = (long long)a.B * a.H * ((a.L + tile - 1) / tile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (a.dtype == DT_BFLOAT16) {
    using T = __nv_bfloat16;
    attn_bwd_dq_bf16<<<(unsigned)blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.mask), static_cast<const T*>(a.o), static_cast<const T*>(a.dout), m, l,
        static_cast<T*>(a.dq), delta, a.qs, a.ks, a.vs, a.os, a.ds, a.mask_sb, a.H, a.L, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkv_bf16<kMask><<<(unsigned)blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.mask), static_cast<const T*>(a.dout), m, l, delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), dmask, a.qs, a.ks, a.vs, a.ds, a.mask_sb, a.H,
        a.L, scale);
  } else if (a.dtype == DT_FLOAT32) {
    using T = float;
    attn_bwd_dq_f32<<<(unsigned)blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.mask), static_cast<const T*>(a.o), static_cast<const T*>(a.dout), m, l,
        static_cast<T*>(a.dq), delta, a.qs, a.ks, a.vs, a.os, a.ds, a.mask_sb, a.H, a.L, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkv_f32<kMask><<<(unsigned)blocks, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.mask), static_cast<const T*>(a.dout), m, l, delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), dmask, a.qs, a.ks, a.vs, a.ds, a.mask_sb, a.H,
        a.L, scale);
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
// dmask [B, H, L] f32 or null when the mask needs no gradient; delta
// [B, H, L] f32 is workspace.
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
