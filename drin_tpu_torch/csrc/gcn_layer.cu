// Fused DRIN GCN layer, entity side, for Hopper (sm_90a).
//
// Replaces drin_tpu/ops/pallas/gcn_layer.py::fused_gcn_layer (body
// _layer_kernel).  For one layer it produces, from ONE read of the old entity
// vertices et/ei [B, C, D]:
//   * et' = act(LN(W_h(et + tt*mt + it*mi))),  ei' = act(LN(W_h(ei + ti*mt + ii*mi)))
//   * the four folded dynamic scalar edges
//       a_u = u.Ku + bu,  p_u = round(a_u).Kv^T,  s_u = a_u.bv
//       e'  = eact((round(p_u).v + s_u) / D + e)     (OLD vertices)
//   * the raw message sums  sum_c(e_c * v_c)  per (vertex set, mention),
//     which the wrapper turns into the two [B, D] mention updates.
// Rounding points follow gcn_layer_reference: x is rounded to the compute
// type before the W_h product, p before the edge dot; messages stay f32.
//
// What bounds it on the H100: at B=64, C=101, D=768 the W_h products are
// 2 x 6464 x 768 x 768 MACs (~15 GFLOP) over ~40 MB of bf16 vertex traffic,
// so the layer is compute-bound on the tensor cores if W_h is fed well.  The
// TPU design (a whole [C, D] tile plus W_h resident in VMEM) does not fit:
// W_h alone is 1.18 MB of bf16 against 227 KB of shared memory per block,
// and the LayerNorm needs the whole 768-wide output row.  So:
//   * Launch A, two small products over all 2B mention rows in 16 x 64 tiles
//     on the tensor cores: a = u.Ku + bu (with per-tile partials of a.bv),
//     then p = round(a).Kv^T (and s, the partials added in order).  Each
//     weight element is read once per 16 mentions.
//   * Launch B, one block per (b, vertex set in {et, ei}): loops over C in
//     tiles of TM rows.  From one read of the old rows it forms x (rounded),
//     the message sums and the edge dots; then x.W_h^T on the tensor cores
//     (WMMA 16x16x16 bf16, f32 accumulators) with W_h read from L2 (it stays
//     resident in the 50 MB L2), the [TM, D] f32 product in shared memory,
//     and an epilogue of bias, LayerNorm over D in f32 and the activation
//     (exact erf gelu).  One block per (b, set) keeps the candidate sums
//     deterministic without atomics; it gives only 2B blocks (128 at B=64
//     against 132 SMs).  The f32 instantiation uses plain FMA loops.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

enum Act : int { ACT_GELU = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3, ACT_IDENTITY = 4 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXPad = 8;  // x tile row pad (bf16 elements): staggers smem banks

__device__ __forceinline__ float act(int code, float x) {
  switch (code) {
    case ACT_GELU: return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_TANH: return tanhf(x);
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-x));
    default: return x;
  }
}

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// ---------------------------------------------------------------- launch A
// The edge fold's two products over all 2B mention rows at once, in tiles of
// kPM rows x kPN columns, so each weight element is read once per row tile
// (not once per mention):
//   A1: a = u . Wu^T + bu  -> round(a) for A2, and per-tile partial sums of a.bv
//   A2: p = round(a) . Wv  -> round(p); s = the partial sums added in order
constexpr int kPM = 16;
constexpr int kPN = 64;
constexpr int kPThreads = 128;  // 4 warps, one 16x16 output fragment each
constexpr int kPWarps = kPThreads / 32;

// c[kPM, kPN] = a_s[kPM, D] . W restricted to columns n0 .. n0 + kPN, with W
//   NT (kNT): W[N][K] row-major (torch [out, in]: the B operand is column-major)
//   NN:       W[K][N] row-major (the B operand is row-major)
template <typename T, bool kNT> struct ProjTile;

template <bool kNT> struct ProjTile<__nv_bfloat16, kNT> {
  using BLayout = typename std::conditional<kNT, wmma::col_major, wmma::row_major>::type;
  static __device__ void run(const __nv_bfloat16* a_s, int lda, const __nv_bfloat16* __restrict__ w,
                             int D, int n0, float* c_s) {
    const int warp = threadIdx.x / 32;
    const int n = n0 + warp * 16;
    if (n >= D) return;  // ragged last column tile (warp-uniform)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 8
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      wmma::load_matrix_sync(af, a_s + k, lda);
      wmma::load_matrix_sync(bf, kNT ? w + (size_t)n * D + k : w + (size_t)k * D + n, D);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(c_s + warp * 16, acc, kPN, wmma::mem_row_major);
  }
};

template <bool kNT> struct ProjTile<float, kNT> {
  static __device__ void run(const float* a_s, int lda, const float* __restrict__ w, int D, int n0,
                             float* c_s) {
    for (int idx = threadIdx.x; idx < kPM * kPN; idx += kPThreads) {
      const int r = idx / kPN, c = idx % kPN, n = n0 + c;
      if (n >= D) continue;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc += a_s[r * lda + k] * (kNT ? w[(size_t)n * D + k] : w[(size_t)k * D + n]);
      c_s[r * kPN + c] = acc;
    }
  }
};

template <typename T>
size_t proj_smem_bytes(int D) {
  return align128((size_t)kPM * (D + kXPad) * sizeof(T)) + (size_t)kPM * kPN * sizeof(float);
}

// rows b0 .. b0 + kPM of src [rows][D] into the tile, zeros past n_rows
template <typename T>
__device__ void load_rows(T* a_s, int lda, const T* __restrict__ src, int b0, int n_rows, int D) {
  for (int idx = threadIdx.x; idx < kPM * D; idx += kPThreads) {
    const int r = idx / D, k = idx % D;
    a_s[r * lda + k] = b0 + r < n_rows ? src[(size_t)(b0 + r) * D + k] : from_f<T>(0.f);
  }
}

// grid (ceil(D / kPN), Bp / kPM, 2 mentions); ar [2][Bp][D]; s_part [2][Bp][gridDim.x]
template <typename T>
__global__ void __launch_bounds__(kPThreads)
proj_a_kernel(const T* __restrict__ mt, const T* __restrict__ mi, const T* __restrict__ wu,
              const T* __restrict__ bu, const T* __restrict__ bv, T* __restrict__ ar,
              float* __restrict__ s_part, int B, int Bp, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + kXPad;
  T* a_s = reinterpret_cast<T*>(smem);
  float* c_s = reinterpret_cast<float*>(smem + align128((size_t)kPM * lda * sizeof(T)));
  const int n0 = blockIdx.x * kPN, b0 = blockIdx.y * kPM, u = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows(a_s, lda, u == 0 ? mt : mi, b0, B, D);
  __syncthreads();
  ProjTile<T, true>::run(a_s, lda, wu, D, n0, c_s);
  __syncthreads();
  for (int r = warp; r < kPM; r += kPWarps) {
    const size_t row = (size_t)u * Bp + b0 + r;
    float part = 0.f;
    for (int c = lane; c < kPN && n0 + c < D; c += 32) {
      const int n = n0 + c;
      const float a = c_s[r * kPN + c] + to_f(bu[n]);
      ar[row * D + n] = from_f<T>(a);  // the reference rounds a before Kv^T
      part += a * to_f(bv[n]);         // s uses the unrounded a
    }
    part = warp_sum(part);
    if (lane == 0) s_part[row * gridDim.x + blockIdx.x] = part;
  }
}

// grid as proj_a; p [B][2][D]; s [B][2]
template <typename T>
__global__ void __launch_bounds__(kPThreads)
proj_p_kernel(const T* __restrict__ ar, const T* __restrict__ wv, const float* __restrict__ s_part,
              T* __restrict__ p_out, float* __restrict__ s_out, int B, int Bp, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + kXPad;
  T* a_s = reinterpret_cast<T*>(smem);
  float* c_s = reinterpret_cast<float*>(smem + align128((size_t)kPM * lda * sizeof(T)));
  const int n0 = blockIdx.x * kPN, b0 = blockIdx.y * kPM, u = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_rows(a_s, lda, ar + (size_t)u * Bp * D, b0, Bp, D);
  __syncthreads();
  ProjTile<T, false>::run(a_s, lda, wv, D, n0, c_s);
  __syncthreads();
  for (int r = warp; r < kPM && b0 + r < B; r += kPWarps) {
    const int b = b0 + r;
    for (int c = lane; c < kPN && n0 + c < D; c += 32)
      p_out[((size_t)b * 2 + u) * D + n0 + c] = from_f<T>(c_s[r * kPN + c]);
    if (blockIdx.x == 0 && lane == 0) {  // s: the column tiles' partials, in order
      const float* sp = s_part + ((size_t)u * Bp + b) * gridDim.x;
      float s = 0.f;
      for (int t = 0; t < (int)gridDim.x; ++t) s += sp[t];
      s_out[b * 2 + u] = s;
    }
  }
}

// ------------------------------------------------- the x.W_h^T tile product
template <typename T, int TM> struct TileGemm;

template <int TM> struct TileGemm<__nv_bfloat16, TM> {
  // h[TM, D] = x[TM, D] . Wh^T; Wh [D(out), D(in)] row-major is exactly the
  // column-major B operand, read straight from global memory (L2-resident).
  static __device__ void run(const __nv_bfloat16* x_s, int xs, const __nv_bfloat16* __restrict__ wh,
                             float* h_s, int D) {
    constexpr int RF = TM / 16;
    const int warp = threadIdx.x / 32;
    for (int nf = warp; nf < D / 16; nf += kWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RF];
#pragma unroll
      for (int r = 0; r < RF; ++r) wmma::fill_fragment(acc[r], 0.0f);
      const __nv_bfloat16* wcol = wh + (size_t)nf * 16 * D;
#pragma unroll 8
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, wcol + k, D);
#pragma unroll
        for (int r = 0; r < RF; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
          wmma::load_matrix_sync(afr, x_s + r * 16 * xs + k, xs);
          wmma::mma_sync(acc[r], afr, bfr, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RF; ++r)
        wmma::store_matrix_sync(h_s + r * 16 * D + nf * 16, acc[r], D, wmma::mem_row_major);
    }
  }
};

template <int TM> struct TileGemm<float, TM> {
  static __device__ void run(const float* x_s, int xs, const float* __restrict__ wh, float* h_s, int D) {
    for (int idx = threadIdx.x; idx < TM * D; idx += kThreads) {
      const int r = idx / D, n = idx % D;
      const float* x = x_s + r * xs;
      const float* w = wh + (size_t)n * D;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc += x[k] * w[k];
      h_s[r * D + n] = acc;
    }
  }
};

template <typename T, int TM>
size_t entity_smem_bytes(int D) {
  return align128((size_t)TM * (D + kXPad) * sizeof(T)) + align128((size_t)TM * D * sizeof(float)) +
         ((size_t)6 * D + 2 * TM) * sizeof(float);
}

// ---------------------------------------------------------------- launch B
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
entity_update_kernel(const T* __restrict__ mt, const T* __restrict__ mi,
                     const T* __restrict__ et, const T* __restrict__ ei,
                     const T* __restrict__ tt, const T* __restrict__ ti,
                     const T* __restrict__ it, const T* __restrict__ ii,
                     const T* __restrict__ wh, const T* __restrict__ bh,
                     const T* __restrict__ lns, const T* __restrict__ lnb,
                     const T* __restrict__ p, const float* __restrict__ s,
                     T* __restrict__ et_o, T* __restrict__ ei_o,
                     T* __restrict__ tt_o, T* __restrict__ ti_o,
                     T* __restrict__ it_o, T* __restrict__ ii_o,
                     float* __restrict__ msg, int C, int D, float eps, int vact, int eact,
                     int dynamic) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int xs = D + kXPad;
  T* x_s = reinterpret_cast<T*>(smem);                            // [TM][xs]
  size_t off = align128((size_t)TM * xs * sizeof(T));
  float* h_s = reinterpret_cast<float*>(smem + off);              // [TM][D]
  off += align128((size_t)TM * D * sizeof(float));
  float* u_s = reinterpret_cast<float*>(smem + off);              // [2][D]  mt, mi
  float* p_s = u_s + 2 * D;                                       // [2][D]  p_mt, p_mi
  float* m_s = p_s + 2 * D;                                       // [2][D]  message sums
  float* e_s = m_s + 2 * D;                                       // [2][TM] tile edges

  const int b = blockIdx.x, set = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // set 0: et with (tt -> mt, it -> mi); set 1: ei with (ti -> mt, ii -> mi)
  const T* V = (set == 0 ? et : ei) + (size_t)b * C * D;
  const T* E1 = (set == 0 ? tt : ti) + (size_t)b * C;
  const T* E2 = (set == 0 ? it : ii) + (size_t)b * C;
  T* Vo = (set == 0 ? et_o : ei_o) + (size_t)b * C * D;
  T* E1o = (set == 0 ? tt_o : ti_o) + (size_t)b * C;
  T* E2o = (set == 0 ? it_o : ii_o) + (size_t)b * C;

  for (int d = tid; d < D; d += kThreads) {
    u_s[d] = to_f(mt[(size_t)b * D + d]);
    u_s[D + d] = to_f(mi[(size_t)b * D + d]);
    p_s[d] = dynamic ? to_f(p[(size_t)b * 2 * D + d]) : 0.f;
    p_s[D + d] = dynamic ? to_f(p[((size_t)b * 2 + 1) * D + d]) : 0.f;
    m_s[d] = 0.f;
    m_s[D + d] = 0.f;
  }
  const float s0 = dynamic ? s[b * 2] : 0.f, s1 = dynamic ? s[b * 2 + 1] : 0.f;

  for (int c0 = 0; c0 < C; c0 += TM) {
    const int rows = min(TM, C - c0);
    if (tid < TM) {
      e_s[tid] = tid < rows ? to_f(E1[c0 + tid]) : 0.f;
      e_s[TM + tid] = tid < rows ? to_f(E2[c0 + tid]) : 0.f;
    }
    __syncthreads();
    // (1) x = round(v + e1*mt + e2*mi) into the tile, message sums; a thread
    //     owns columns, so the sums need no atomics
    for (int d = tid; d < D; d += kThreads) {
      const float um = u_s[d], ui = u_s[D + d];
      float m1 = m_s[d], m2 = m_s[D + d];
      for (int r = 0; r < TM; ++r) {
        T xv = from_f<T>(0.f);
        if (r < rows) {
          const float v = to_f(V[(size_t)(c0 + r) * D + d]);
          const float e1 = e_s[r], e2 = e_s[TM + r];
          xv = from_f<T>(v + e1 * um + e2 * ui);
          m1 += e1 * v;
          m2 += e2 * v;
        }
        x_s[r * xs + d] = xv;
      }
      m_s[d] = m1;
      m_s[D + d] = m2;
    }
    // (2) dynamic edges from the OLD rows, a warp per row
    if (dynamic) {
      for (int r = warp; r < rows; r += kWarps) {
        const T* vr = V + (size_t)(c0 + r) * D;
        float d1 = 0.f, d2 = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float v = to_f(vr[d]);
          d1 += p_s[d] * v;
          d2 += p_s[D + d] * v;
        }
        d1 = warp_sum(d1);
        d2 = warp_sum(d2);
        if (lane == 0) {
          E1o[c0 + r] = from_f<T>(act(eact, (d1 + s0) / D + e_s[r]));
          E2o[c0 + r] = from_f<T>(act(eact, (d2 + s1) / D + e_s[TM + r]));
        }
      }
    }
    __syncthreads();
    // (3) h = x . W_h^T
    TileGemm<T, TM>::run(x_s, xs, wh, h_s, D);
    __syncthreads();
    // (4) bias + LayerNorm (f32, two-pass variance) + activation, a warp per row
    for (int r = warp; r < rows; r += kWarps) {
      float* h = h_s + r * D;
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float x = h[d] + to_f(bh[d]);
        h[d] = x;
        sum += x;
      }
      const float mu = warp_sum(sum) / D;
      float sq = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float c = h[d] - mu;
        sq += c * c;
      }
      const float rstd = rsqrtf(warp_sum(sq) / D + eps);
      T* o = Vo + (size_t)(c0 + r) * D;
      for (int d = lane; d < D; d += 32)
        o[d] = from_f<T>(act(vact, (h[d] - mu) * rstd * to_f(lns[d]) + to_f(lnb[d])));
    }
    __syncthreads();
  }
  // raw message sums [B][set][mention][D]; the wrapper adds the sets, divides by C
  float* mo = msg + ((size_t)b * 2 + set) * 2 * D;
  for (int d = tid; d < D; d += kThreads) {
    mo[d] = m_s[d];
    mo[D + d] = m_s[D + d];
  }
}

template <typename T, int TM>
int launch(int B, int C, int D, float eps, int vact, int eact, int dynamic, const void* const* in,
           void* a_ws, void* sp_ws, void* p_ws, void* s_ws, void* const* out, void* msg,
           cudaStream_t stream) {
  const T* mt = static_cast<const T*>(in[0]);
  const T* mi = static_cast<const T*>(in[1]);
  cudaError_t err;
  if (dynamic) {
    const int Bp = (B + kPM - 1) / kPM * kPM;
    const dim3 grid((D + kPN - 1) / kPN, Bp / kPM, 2);
    const size_t sm_p = proj_smem_bytes<T>(D);
    if (sm_p > 48 * 1024) {
      err = cudaFuncSetAttribute(proj_a_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_p);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(proj_p_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_p);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    T* ar = static_cast<T*>(a_ws);
    float* s_part = static_cast<float*>(sp_ws);
    proj_a_kernel<T><<<grid, kPThreads, sm_p, stream>>>(
        mt, mi, static_cast<const T*>(in[12]), static_cast<const T*>(in[13]),
        static_cast<const T*>(in[15]), ar, s_part, B, Bp, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    proj_p_kernel<T><<<grid, kPThreads, sm_p, stream>>>(
        ar, static_cast<const T*>(in[14]), s_part, static_cast<T*>(p_ws),
        static_cast<float*>(s_ws), B, Bp, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t sm_b = entity_smem_bytes<T, TM>(D);
  err = cudaFuncSetAttribute(entity_update_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  entity_update_kernel<T, TM><<<dim3(B, 2), kThreads, sm_b, stream>>>(
      mt, mi, static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]), static_cast<const T*>(in[6]),
      static_cast<const T*>(in[7]), static_cast<const T*>(in[8]), static_cast<const T*>(in[9]),
      static_cast<const T*>(in[10]), static_cast<const T*>(in[11]), static_cast<const T*>(p_ws),
      static_cast<const float*>(s_ws), static_cast<T*>(out[0]), static_cast<T*>(out[1]),
      static_cast<T*>(out[2]), static_cast<T*>(out[3]), static_cast<T*>(out[4]),
      static_cast<T*>(out[5]), static_cast<float*>(msg), C, D, eps, vact, eact, dynamic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs, all contiguous in the compute type: mt, mi [B, D]; et, ei [B, C, D];
// tt, ti, it, ii [B, C]; W_h [D, D] (torch [out, in]); b_h, ln scale, ln bias [D];
// Wu, bu, Wv, bv (torch layout; unused when dynamic == 0).
// Workspace: round(a) [2, Bp, D] compute type and partial sums [2, Bp, ceil(D/64)] f32
// with Bp = B rounded up to 16; p [B, 2, D] compute type, s [B, 2] f32.  Outputs: et', ei' [B, C, D];
// tt', ti', it', ii' [B, C] (written only when dynamic); msg [B, 2, 2, D] f32.
DRIN_EXPORT int drin_gcn_layer(int dtype, int B, int C, int D, float eps, int vact, int eact,
                               int dynamic, const void* mt, const void* mi, const void* et,
                               const void* ei, const void* tt, const void* ti, const void* it,
                               const void* ii, const void* wh, const void* bh, const void* lns,
                               const void* lnb, const void* wu, const void* bu, const void* wv,
                               const void* bv, void* a_ws, void* sp_ws, void* p_ws, void* s_ws,
                               void* et_o, void* ei_o,
                               void* tt_o, void* ti_o, void* it_o, void* ii_o, void* msg,
                               void* stream) {
  if (B < 1 || C < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[16] = {mt, mi, et, ei, tt, ti, it, ii, wh, bh, lns, lnb, wu, bu, wv, bv};
  void* out[6] = {et_o, ei_o, tt_o, ti_o, it_o, ii_o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BFLOAT16) {
    if (D % 16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<__nv_bfloat16, 32>(B, C, D, eps, vact, eact, dynamic, in, a_ws, sp_ws, p_ws, s_ws,
                                      out, msg, s);
  }
  if (dtype == DT_FLOAT32)
    return launch<float, 16>(B, C, D, eps, vact, eact, dynamic, in, a_ws, sp_ws, p_ws, s_ws, out,
                            msg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
