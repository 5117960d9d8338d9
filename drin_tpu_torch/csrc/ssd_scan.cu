// Mamba-2's chunked SSD scan (state space duality), forward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no state-space layer.  It
// is the scan of the granite-4.0-h-micro text tower's 36 Mamba-2 layers
// (encoders/granite_hybrid.py), one group, heads of P = 64 channels over a
// state of N = 128.  For each sequence b, head h and token t:
//
//   S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t      (S: [P, N])
//   y_t = S_t . C_t + D_h * x_t
//
// taken in chunks of Q = 256 tokens, as Mamba-2's SSD algorithm takes it
// (Dao and Gu, arXiv 2405.21060, section 6).  With cum_t the running sum of
// dt * A inside the chunk and H the state carried into the chunk:
//
//   y_t = exp(cum_t) * C_t . H^T                                (the carried state)
//       + sum_{s <= t} (C_t . B_s) * exp(cum_t - cum_s) * dt_s * x_s   (inside the chunk)
//       + D_h * x_t
//   H' = exp(cum_Q) * H + sum_s exp(cum_Q - cum_s) * dt_s * x_s (outer) B_s
//
// What bounds it on the H100: at the entity pass's [32, 896, 64 heads] a
// layer reads 0.24 GB of x and writes as much of y (B, C and dt are small),
// 0.14 ms at 3.35 TB/s, and its products are ~120 GFLOP, 0.12 ms at the
// bf16 rate: the two bounds lie together, so the kernel has to keep the
// [Q, Q] products and the state out of device memory and run its products
// on the tensor cores.  Its design:
//   * one block per (b, h), 8 warps, walking the sequence's chunks in order:
//     the carried state lives in the warps' accumulator fragments (each warp
//     a 16 x 64 block of the 64 x 128 state, float32) and never reaches
//     device memory;
//   * a chunk's x [Q, 64] and B [Q, 128] (bf16) and its dt land in shared
//     memory once; its decay sums cum are one block-wide scan;
//   * each warp owns two 16-row strips of the chunk's outputs (strips w and
//     15 - w, so that the causal work is even): the carried state's term
//     C . H^T, then per tile of 64 earlier keys the scores C . B^T, weighted
//     by exp(cum_t - cum_s) * dt_s on the causal side and rounded to bf16,
//     times x; every product is a bf16 WMMA with float32 accumulators;
//   * the new state is exp(cum_Q) * H plus x^T . (B weighted by
//     exp(cum_Q - cum_s) * dt_s, rounded to bf16), accumulated onto the
//     state fragments; the carried state enters the next chunk's products
//     rounded to bf16 (Mamba-2's own kernels round it to the input type too).
// Decays and sums are float32 throughout.  ops/cuda/ssd.py's ssd_plain has the
// same rounding points.  Scores C . B^T are taken per head (one group shares
// them over heads), which doubles the products the bound counts once.
//
// Layouts: x [b, t, h, p] and B, C [b, t, n] bf16 through element strides of
// b and t (p and n contiguous, every row 16-byte aligned: views into the
// conv's output); dt [b, t, h] float32 through its strides; A, D [H] float32;
// y [b, t, h, p] bf16 contiguous.  Tokens past L are read as zeros.

#include <mma.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kP = 64;          // channels of a head
constexpr int kN = 128;         // state size
constexpr int kChunk = 256;     // tokens a chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // one thread a token of the chunk in the scan
constexpr int kStrip = 16;      // output rows of a warp's strip
constexpr int kTile = 64;       // keys a tile of scores
constexpr int kLdB = kN + 8;    // padded rows against bank conflicts (ldm a multiple of 8)
constexpr int kLdX = kP + 8;
constexpr int kLdF = kTile + 4;  // float32 scratch
constexpr int kLdW = kTile + 8;  // bf16 weights

static_assert(kThreads == kChunk, "the decay scan takes one thread a token");
static_assert(2 * kWarps * kStrip == kChunk, "two strips a warp cover the chunk");

constexpr int kBytesB = kChunk * kLdB * 2;
constexpr int kBytesX = kChunk * kLdX * 2;
constexpr int kBytesH = kP * kLdB * 2;
constexpr int kBytesScan = 2 * kChunk * 4 + 128;  // cum, dt, the warps' totals
constexpr int kBytesC = kStrip * kLdB * 2;
constexpr int kBytesF = kStrip * kLdF * 4;
constexpr int kBytesW = kStrip * kLdW * 2;
constexpr int kBytesWarp = kBytesC + kBytesF + kBytesW;
constexpr int kSmem = kBytesB + kBytesX + kBytesH + kBytesScan + kWarps * kBytesWarp;
static_assert(kSmem <= 232448, "shared memory of one block");
static_assert(kBytesB % 128 == 0 && kBytesX % 128 == 0 && kBytesH % 128 == 0 &&
              kBytesScan % 128 == 0 && kBytesC % 128 == 0 && kBytesF % 128 == 0 &&
              kBytesW % 128 == 0, "every buffer 128-byte aligned");

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

__device__ __forceinline__ uint4 load_row16(const bf16* p, bool in) {
  return in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_bf16(const bf16* __restrict__ x, long long sxb, long long sxl,
             const bf16* __restrict__ Bm, long long sbb, long long sbl,
             const bf16* __restrict__ Cm, long long scb, long long scl,
             const float* __restrict__ dt, long long sdb, long long sdl,
             const float* __restrict__ A, const float* __restrict__ Dv,
             bf16* __restrict__ y, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem);
  bf16* sX = reinterpret_cast<bf16*>(smem + kBytesB);
  bf16* sH = reinterpret_cast<bf16*>(smem + kBytesB + kBytesX);
  float* sCum = reinterpret_cast<float*>(smem + kBytesB + kBytesX + kBytesH);
  float* sDt = sCum + kChunk;
  float* sTot = sDt + kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* mine = smem + kBytesB + kBytesX + kBytesH + kBytesScan + warp * kBytesWarp;
  bf16* sC = reinterpret_cast<bf16*>(mine);
  float* sF = reinterpret_cast<float*>(mine + kBytesC);
  bf16* sW = reinterpret_cast<bf16*>(mine + kBytesC + kBytesF);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float Ah = A[h], Dh = Dv[h];
  const bf16* xb = x + b * sxb + h * kP;
  const bf16* Bb = Bm + b * sbb;
  const bf16* Cb = Cm + b * scb;
  const float* dtb = dt + b * sdb + h;
  bf16* yb = y + (size_t)b * L * H * kP + (size_t)h * kP;

  // the state's block of this warp: rows [p0, p0 + 16), columns [n0, n0 + 64)
  const int p0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  FragAcc state[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(state[j], 0.f);

  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, Lc = min(kChunk, L - t0);
    // x and B of the chunk, zeros past L
    for (int i = tid; i < kChunk * (kP / 8); i += kThreads) {
      const int r = i / (kP / 8), v = i % (kP / 8);
      *reinterpret_cast<uint4*>(sX + r * kLdX + v * 8) =
          load_row16(xb + (long long)(t0 + r) * sxl + v * 8, r < Lc);
    }
    for (int i = tid; i < kChunk * (kN / 8); i += kThreads) {
      const int r = i / (kN / 8), v = i % (kN / 8);
      *reinterpret_cast<uint4*>(sB + r * kLdB + v * 8) =
          load_row16(Bb + (long long)(t0 + r) * sbl + v * 8, r < Lc);
    }
    // dt and the inclusive sum of dt * A (one thread a token)
    const float d = tid < Lc ? dtb[(long long)(t0 + tid) * sdl] : 0.f;
    float a = d * Ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, a, o);
      if (lane >= o) a += n;
    }
    if (lane == 31) sTot[warp] = a;
    sDt[tid] = d;
    if (c > 0) {  // the carried state, rounded to bf16, for this chunk's products
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(sF + j * 16, state[j], kLdF, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 64; e += 32) {
        const int r = e / 64, col = e % 64;
        sH[(p0 + r) * kLdB + n0 + col] = __float2bfloat16_rn(sF[r * kLdF + col]);
      }
      __syncwarp();
    }
    __syncthreads();
    float prefix = 0.f;
    for (int w = 0; w < warp; ++w) prefix += sTot[w];
    sCum[tid] = a + prefix;
    __syncthreads();

    // the outputs, two strips a warp
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const int r0 = kStrip * (k == 0 ? warp : 2 * kWarps - 1 - warp);
      if (r0 >= Lc) continue;
      for (int i = lane; i < kStrip * (kN / 8); i += 32) {
        const int r = i / (kN / 8), v = i % (kN / 8);
        *reinterpret_cast<uint4*>(sC + r * kLdB + v * 8) =
            load_row16(Cb + (long long)(t0 + r0 + r) * scl + v * 8, r0 + r < Lc);
      }
      __syncwarp();
      FragAcc acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      if (c > 0) {  // exp(cum_t) * C_t . H^T
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          FragARow fa;
          wmma::load_matrix_sync(fa, sC + kk * 16, kLdB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragBCol fb;
            wmma::load_matrix_sync(fb, sH + j * 16 * kLdB + kk * 16, kLdB);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(sF + j * 16, acc[j], kLdF, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 64; e += 32) {
          const int r = e / 64, col = e % 64;
          sF[r * kLdF + col] *= expf(sCum[r0 + r]);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(acc[j], sF + j * 16, kLdF, wmma::mem_row_major);
      }
      // inside the chunk, a tile of 64 keys at a time up to the strip's last row
      const int last = (r0 + kStrip - 1) / kTile;
#pragma unroll 1
      for (int jt = 0; jt <= last; ++jt) {
        const int s0 = jt * kTile;
        FragAcc sc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(sc[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          FragARow fa;
          wmma::load_matrix_sync(fa, sC + kk * 16, kLdB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragBCol fb;
            wmma::load_matrix_sync(fb, sB + (s0 + j * 16) * kLdB + kk * 16, kLdB);
            wmma::mma_sync(sc[j], fa, fb, sc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(sF + j * 16, sc[j], kLdF, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 64; e += 32) {
          const int r = e / 64, col = e % 64, t = r0 + r, s = s0 + col;
          const float w = s <= t ? sF[r * kLdF + col] * (expf(sCum[t] - sCum[s]) * sDt[s]) : 0.f;
          sW[r * kLdW + col] = __float2bfloat16_rn(w);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          FragARow fw;
          wmma::load_matrix_sync(fw, sW + kk * 16, kLdW);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            FragBRow fx;
            wmma::load_matrix_sync(fx, sX + (s0 + kk * 16) * kLdX + j * 16, kLdX);
            wmma::mma_sync(acc[j], fw, fx, acc[j]);
          }
        }
        __syncwarp();
      }
      // y = the sum + D * x, two channels a lane, a row a pass
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(sF + j * 16, acc[j], kLdF, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kStrip * 32; e += 32) {
        const int r = e / 32, col = 2 * (e % 32), t = r0 + r;
        if (t >= Lc) break;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sX + t * kLdX + col));
        *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)(t0 + t) * H * kP + col) =
            __floats2bfloat162_rn(sF[r * kLdF + col] + Dh * xv.x, sF[r * kLdF + col + 1] + Dh * xv.y);
      }
      __syncwarp();
    }

    if (c + 1 < n_chunks) {  // the state carried into the next chunk
      __syncthreads();  // every warp is done with B as it came
      const float cend = sCum[kChunk - 1];
      for (int i = tid; i < kChunk * kN / 2; i += kThreads) {
        const int s = i / (kN / 2), n = 2 * (i % (kN / 2));
        const float w = expf(cend - sCum[s]) * sDt[s];
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sB + s * kLdB + n);
        const float2 v = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(v.x * w, v.y * w);
      }
      __syncthreads();
      const float decay = expf(cend);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        for (int e = 0; e < state[j].num_elements; ++e) state[j].x[e] *= decay;
#pragma unroll 4
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        FragACol fa;  // x^T: row p, column s
        wmma::load_matrix_sync(fa, sX + ks * 16 * kLdX + p0, kLdX);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBRow fb;
          wmma::load_matrix_sync(fb, sB + ks * 16 * kLdB + n0 + j * 16, kLdB);
          wmma::mma_sync(state[j], fa, fb, state[j]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites x, B, cum and dt
  }
}

}  // namespace

// N sequences of L tokens, H heads of 64 channels, a state of 128: see the
// layouts at the top.  Strides are in elements; x, B and C need 16-byte
// aligned rows (the wrapper checks).
DRIN_EXPORT int drin_ssd_fwd_bf16(const void* x, long long sxb, long long sxl, const void* B,
                                  long long sbb, long long sbl, const void* C, long long scb,
                                  long long scl, const void* dt, long long sdb, long long sdl,
                                  const void* A, const void* D, void* y, int N, int L, int H,
                                  void* stream) {
  if (N < 1 || L < 1 || H < 1 || (long long)N * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted = allow_smem(ssd_fwd_bf16, kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  ssd_fwd_bf16<<<(unsigned)(N * H), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), sxb, sxl, static_cast<const bf16*>(B), sbb, sbl,
      static_cast<const bf16*>(C), scb, scl, static_cast<const float*>(dt), sdb, sdl,
      static_cast<const float*>(A), static_cast<const float*>(D), static_cast<bf16*>(y), L, H);
  return static_cast<int>(cudaGetLastError());
}
