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
// traffic (0.090 ms), so both limits are close and neither is near while the
// products run through mma.sync.  The TPU kernel keeps all of K and V of one
// (b, h) and a [block_q, L] f32 logits tile in fast memory and takes the exact
// row softmax; here K and V at L=512 (128 KB) plus such a tile do not fit the
// 227 KB a block may use, and a 16 x 512 f32 strip per warp does not fit in
// registers.  So the bf16 kernel streams:
//   * one block per (b, h, tile of 64 query rows), four warps of 16 rows;
//   * K and V come through shared memory in tiles of 64 keys, double-buffered
//     with cp.async (36 KB of static shared memory, four blocks per SM);
//   * both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulators); the logits accumulator's register layout is the A
//     operand's, so p goes from the first product to the second without
//     touching shared memory; V's B operand comes through ldmatrix.trans;
//   * running row max and row sum in registers, the accumulator rescaled per
//     key tile, one division at the end.
// Same function as the TPU kernel within rounding; the one difference: p is
// rounded to bf16 before the normalisation (exp(logit - running max), in
// (0, 1]) rather than after it.
//
// The mask keeps its magnitude (about -3.4e38, finite), so all masked logits
// of a row are equal and a row with every key masked gets the uniform softmax
// of the reference.  Keys past L (the ragged last tile) get -inf; the running
// max is finite from the first tile on (key 0 is always in range), so
// (-inf) - (-inf) never forms.
//
// The f32 instantiation is a plain-FMA kernel of the same streaming form
// (64 query rows per block, two threads per row, tiles of 32 keys).
//
// Where a gradient will be asked for, both kernels also store the row max m
// and the row sum l of exp(logit - m), [B, H, L] f32 each: the backward
// (attention_bwd.cu) recomputes P = exp(S - m) / l from them.  Inference
// passes null pointers and stores nothing.

#include "attention_common.cuh"

namespace {

// grid: B * H * ceil(L / 64) blocks, the query tiles of one (b, h) adjacent
// (their K and V then meet in L2); out is [B, L, H, 64] contiguous.  The
// kernel waits on latency (dependent mma chains, two barriers per key tile),
// so resident warps count: asking for four blocks per SM caps it at 128
// registers (it would take 139, three blocks) at the price of 44 bytes of
// spill stores and 36 of loads per thread.
__global__ void __launch_bounds__(kThreads, 4)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ mask,
              __nv_bfloat16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
              Strides qs, Strides ks, Strides vs, long long mask_sb, int H, int L, float scale) {
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
  const int n_kt = (L + kBK - 1) / kBK;

  // the query tile is staged through K's second buffer
  load_tile(k_s[1], qp, qs.l, q0, L);
  cp_async_commit();
  load_tile(k_s[0], kp, ks.l, 0, L);
  load_tile(v_s[0], vp, vs.l, 0, L);
  cp_async_commit();
  fill_mask(mask_s, mask, mask_sb, b, L);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const __nv_bfloat16* r0 = &k_s[1][warp * 16 + g][kk * 16 + t * 2];
    const __nv_bfloat16* r8 = &k_s[1][warp * 16 + g + 8][kk * 16 + t * 2];
    qf[kk][0] = ld_u32(r0);
    qf[kk][1] = ld_u32(r8);
    qf[kk][2] = ld_u32(r0 + 8);
    qf[kk][3] = ld_u32(r8 + 8);
  }
  __syncthreads();  // the staged queries are read before tile 1 overwrites them

  float o[kDh / 8][4];
#pragma unroll
  for (int j = 0; j < kDh / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};                       // this thread's share of the row sums

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

    // s = q . k^T for 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[buf][j * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[j], qf[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }
    // logits, tile row max (the four lanes of a quad share a row)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float m0 = mask_s[kt * kBK + j * 8 + t * 2], m1 = mask_s[kt * kBK + j * 8 + t * 2 + 1];
      s[j][0] = s[j][0] * scale + m0;
      s[j][1] = s[j][1] * scale + m1;
      s[j][2] = s[j][2] * scale + m0;
      s[j][3] = s[j][3] * scale + m1;
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: tile 0 holds key 0
      alpha[r] = __expf(m_run[r] - m_new);         // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = __expf(s[j][0] - m_run[0]);
      s[j][1] = __expf(s[j][1] - m_run[0]);
      s[j][2] = __expf(s[j][2] - m_run[1]);
      s[j][3] = __expf(s[j][3] - m_run[1]);
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // o += round(p) . v
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDh / 8; j += 2) {
        // four transposed 8x8 blocks of V: keys kk*16 + {0..7, 8..15}, columns j*8 and (j+1)*8
        uint32_t b0, b1, b2, b3;
        const uint32_t addr = smem_u32(&v_s[buf][kk * 16 + (lane % 16)][j * 8 + (lane / 16) * 8]);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(addr));
        mma_bf16(o[j], pa, b0, b1);
        mma_bf16(o[j + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= L) continue;
    if (m_out && t == 0) {  // the softmax residuals of the backward: row max and row sum
      m_out[(size_t)bh * L + row] = m_run[r];
      l_out[(size_t)bh * L + row] = l_run[r];
    }
    __nv_bfloat16* op = out + (((size_t)b * L + row) * H + h) * kDh + t * 2;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kFQ = 64;          // query rows per block, two threads per row
constexpr int kFK = 32;          // keys per tile
constexpr int kFRow = kDh + 4;   // padded tile row (floats), rows stay 16-byte aligned

__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, Strides qs, Strides ks, Strides vs, long long mask_sb, int H,
             int L, float scale) {
  __shared__ __align__(16) float k_s[kFK][kFRow];
  __shared__ __align__(16) float v_s[kFK][kFRow];
  __shared__ float s_s[kFQ][kFK + 1];
  __shared__ float mask_s[kMaxL];

  const int n_qt = (L + kFQ - 1) / kFQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh % H;
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;  // the row's two threads share a warp
  const int row = qt * kFQ + r;
  const float* kp = k + (size_t)b * ks.b + (size_t)h * ks.h;
  const float* vp = v + (size_t)b * vs.b + (size_t)h * vs.h;

  float4 qr[kDh / 4];
  {
    const float4* qrow = reinterpret_cast<const float4*>(
        q + (size_t)b * qs.b + (size_t)h * qs.h + (size_t)(row < L ? row : 0) * qs.l);
#pragma unroll
    for (int i = 0; i < kDh / 4; ++i) qr[i] = row < L ? qrow[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fill_mask(mask_s, mask, mask_sb, b, L);

  float acc[kDh / 2];  // this thread's half of the output row
#pragma unroll
  for (int d = 0; d < kDh / 2; ++d) acc[d] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  for (int k0 = 0; k0 < L; k0 += kFK) {
    __syncthreads();  // the previous tile is read; also orders mask_s on the first pass
    for (int c = threadIdx.x; c < kFK * kDh / 4; c += kThreads) {
      const int kr = c / (kDh / 4), col = (c % (kDh / 4)) * 4;
      const bool in = k0 + kr < L;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&k_s[kr][col]) =
          in ? *reinterpret_cast<const float4*>(kp + (size_t)(k0 + kr) * ks.l + col) : z;
      *reinterpret_cast<float4*>(&v_s[kr][col]) =
          in ? *reinterpret_cast<const float4*>(vp + (size_t)(k0 + kr) * vs.l + col) : z;
    }
    __syncthreads();
    // this thread's 16 of the row's 32 logits
    for (int kk = 0; kk < kFK / 2; ++kk) {
      const int key = kk * 2 + half;
      const float4* kr = reinterpret_cast<const float4*>(&k_s[key][0]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDh / 4; ++i) {
        const float4 kv = kr[i];
        dot += qr[i].x * kv.x + qr[i].y * kv.y + qr[i].z * kv.z + qr[i].w * kv.w;
      }
      s_s[r][key] = dot * scale + mask_s[k0 + key];
    }
    __syncwarp();
    float mx = -CUDART_INF_F;
    for (int key = 0; key < kFK; ++key) mx = fmaxf(mx, s_s[r][key]);
    const float m_new = fmaxf(m_run, mx);       // finite: tile 0 holds key 0
    const float alpha = expf(m_run - m_new);    // 0 on the first tile
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < kDh / 2; ++d) acc[d] *= alpha;
    for (int key = 0; key < kFK; ++key) {
      const float p = expf(s_s[r][key] - m_new);
      l_run += p;
      const float4* vr = reinterpret_cast<const float4*>(&v_s[key][half * (kDh / 2)]);
#pragma unroll
      for (int i = 0; i < kDh / 8; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] += p * vv.x;
        acc[4 * i + 1] += p * vv.y;
        acc[4 * i + 2] += p * vv.z;
        acc[4 * i + 3] += p * vv.w;
      }
    }
  }
  if (row < L) {
    if (m_out && half == 0) {
      m_out[(size_t)bh * L + row] = m_run;
      l_out[(size_t)bh * L + row] = l_run;
    }
    const float inv = 1.f / l_run;
    float4* op = reinterpret_cast<float4*>(out + (((size_t)b * L + row) * H + h) * kDh + half * (kDh / 2));
#pragma unroll
    for (int i = 0; i < kDh / 8; ++i)
      op[i] = make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv, acc[4 * i + 2] * inv,
                          acc[4 * i + 3] * inv);
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
    const long long blocks = (long long)B * H * ((L + kBQ - 1) / kBQ);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attn_fwd_bf16<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(mask),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), qs,
        ks, vs, mask_sb, H, L, scale);
  } else if (dtype == DT_FLOAT32) {
    const long long blocks = (long long)B * H * ((L + kFQ - 1) / kFQ);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    attn_fwd_f32<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), qs, ks, vs, mask_sb, H, L, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
