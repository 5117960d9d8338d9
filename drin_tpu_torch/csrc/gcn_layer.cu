// Fused DRIN GCN layer, entity side, for Hopper (sm_90a).
//
// Replaces drin_tpu/ops/pallas/gcn_layer.py::fused_gcn_layer (body
// _layer_kernel).  For one layer it produces, from ONE read of the old entity
// vertices et/ei [B, C, D]:
//   * et' = act(LN(W_h(et + tt*mt + it*mi))),  ei' = act(LN(W_h(ei + ti*mt + ii*mi)))
//   * the four folded dynamic scalar edges
//       a_u = u.Ku + bu,  p_u = round(a_u).Kv^T,  s_u = a_u.bv
//       e'  = eact((round(p_u).v + s_u) / D + e)     (OLD vertices)
//   * the message sums  sum_c(e_c * v_c)  per (vertex set, mention), and from
//     them the two mention updates  u' = act(LN(W_h(u + msg / C))).
// Rounding points follow gcn_layer_reference: x is rounded to the compute
// type before the W_h product, p before the edge dot; messages stay f32.
//
// What bounds it on the H100: at B=64, C=101, D=768 the W_h products are
// 2 x 6464 x 768 x 768 MACs (~15 GFLOP) over ~40 MB of bf16 vertex traffic,
// so the layer is bound by the tensor cores if W_h reaches them fast enough.
// The TPU design (a whole [C, D] tile plus W_h resident in VMEM) does not fit:
// W_h alone is 1.18 MB of bf16 against 227 KB of shared memory per block, and
// the LayerNorm needs the whole 768-wide output row.  The bf16 path is built
// from one piece, gcn_rows_bf16: rows x W^T with a row-wise epilogue.
//   * A block owns 64 rows and all D outputs: two warpgroups of 64 x D/2, the
//     f32 accumulators in registers (192 a thread at D=768).  W arrives in
//     K-slices of 64 (all D rows of W, D/64 tiles of [64, 64]) through a TMA /
//     mbarrier ring, 128-byte swizzled; the block's 64 rows of the same slice
//     come with it.  One elected thread issues the copies.
//   * The rows become wgmma's A operand in the slice's prologue, in place in
//     shared memory (x = round(v + e1*u1 + e2*u2), rounded once as the plain
//     version does) and then from registers (ldmatrix); each k-step is D/128
//     wgmma m64n64k16 per warpgroup with B read by the tensor cores from the
//     W tiles.  The prologue of slice i+1 runs while the products of slice i
//     are in flight.
//   * The epilogue adds the bias, takes the two-pass LayerNorm in f32 (quad
//     shuffles, then one exchange between the warpgroups in shared memory)
//     and the activation (exact erf gelu), and stores bf16 rows.
// At 64 rows a block each W element is used for 64 rows, so the W slices from
// L2 (the 1.18 MB stay resident) set the pace, not the tensor cores.
// The layer is four launches (A1, A2, B, C) with no torch op between them:
//   A1: a = u.Ku^T + bu over the 2B mention rows (blocks of 64 rows x 128
//       columns), round(a) stored, per-64-column partials of a.bv;
//   A2: p = round(a).Kv (B read MN-major, as Kv^T lies in torch layout);
//   B:  the 2BC entity rows, flat, tiles of 64 that never cross from et to ei.
//       The slice's old rows also give the message sums (the first
//       warpgroup, a (column, mention) per thread walking the rows, written
//       per tile and (b, set) segment into a slot of its own: no atomics, a
//       fixed order) and the edge dots p.v (added up by the threads that form
//       x, over their columns and the K-slices).  The last block to finish
//       with a b (a counter per b) forms launch C's x rows of b,
//       round(u + (the slots, summed in order) / C);
//   C:  the 2B mention rows through the same product and LayerNorm.
// The epilogue has gelu compiled in (the other activations switch at run
// time).
// The f32 instantiations are the plain-FMA kernels below (one block per
// (b, vertex set), 16-row tiles; launch A in 16 x 64 tiles); their two
// mention updates are finished by the wrapper in torch.
//
// The same file holds the port of drin_tpu/ops/pallas/gcn.py::
// fused_vertex_update: gcn_rows_bf16 over the B*C rows without the edge dots
// and the messages (and vertex_update_kernel, its f32 form).

#include "hopper.cuh"

// The compiled-in configuration (tools/gcn_sweep.py builds others with -D).
#ifndef DRIN_GCN_STAGES
#define DRIN_GCN_STAGES 4      // most K-slices in the ring (as many as fit, up to this)
#endif
#ifndef DRIN_GCN_PROJ_COLS
#define DRIN_GCN_PROJ_COLS 128 // launches A1 and A2: output columns of one block
#endif

namespace {

enum Act : int { ACT_GELU = 0, ACT_RELU = 1, ACT_TANH = 2, ACT_SIGMOID = 3, ACT_IDENTITY = 4 };


__device__ __forceinline__ float act(int code, float x) {
  switch (code) {
    case ACT_GELU: return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_TANH: return tanhf(x);
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-x));
    default: return x;
  }
}

// ====================================================================== f32
// Plain FMA loops, for correctness: the layer as launch A (the fold) and
// launch B (one block per (b, vertex set)), and the vertex update.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kXPad = 8;  // x tile row pad (elements)

__host__ __device__ __forceinline__ size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// ---------------------------------------------------------------- launch A
// The edge fold's two products over all 2B mention rows at once, in tiles of
// kPM rows x kPN columns:
//   A1: a = u . Wu^T + bu  -> round(a) for A2, and per-tile partial sums of a.bv
//   A2: p = round(a) . Wv  -> round(p); s = the partial sums added in order
constexpr int kPM = 16;
constexpr int kPN = 64;
constexpr int kPThreads = 128;
constexpr int kPWarps = kPThreads / 32;

// c[kPM, kPN] = a_s[kPM, D] . W restricted to columns n0 .. n0 + kPN, with W
//   NT (kNT): W[N][K] row-major (torch [out, in]: the B operand is column-major)
//   NN:       W[K][N] row-major (the B operand is row-major)
template <typename T, bool kNT> struct ProjTile;

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

// bias + LayerNorm (f32, two-pass variance) + activation over the first `rows`
// rows of the product tile h_s [.][D], a warp per row; out holds the rows
template <typename T>
__device__ void norm_act_rows(float* h_s, int rows, const T* __restrict__ bh, const T* __restrict__ lns,
                              const T* __restrict__ lnb, T* __restrict__ out, int D, float eps,
                              int vact) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
    T* o = out + (size_t)r * D;
    for (int d = lane; d < D; d += 32)
      o[d] = from_f<T>(act(vact, (h[d] - mu) * rstd * to_f(lns[d]) + to_f(lnb[d])));
  }
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
    // (4) bias + LayerNorm + activation
    norm_act_rows(h_s, rows, bh, lns, lnb, Vo + (size_t)c0 * D, D, eps, vact);
    __syncthreads();
  }
  // raw message sums [B][set][mention][D]; the wrapper adds the sets, divides by C
  float* mo = msg + ((size_t)b * 2 + set) * 2 * D;
  for (int d = tid; d < D; d += kThreads) {
    mo[d] = m_s[d];
    mo[D + d] = m_s[D + d];
  }
}

// ------------------------------------------------------- the vertex update
// Replaces drin_tpu/ops/pallas/gcn.py::fused_vertex_update:
//   y = act(LN((v + e1*m1 + e2*m2) . W^T + b))
// for v [B, C, D], e1, e2 [B, C], m1, m2 [B, D], W [D, D] (torch [out, in]),
// x rounded to the compute type before the product (the TPU kernel feeds x in
// the compute type to the matrix unit too).  At B=64, C=101, D=768 the product
// is 7.6 GFLOP over ~21 MB: bound by the tensor cores.  The bf16 form is
// gcn_rows_bf16 over the B*C rows (M_VERTEX); this f32 form is launch B's
// loop without the edge dots and message sums, a block per (tile of TM
// candidates, b).
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
vertex_update_kernel(const T* __restrict__ v, const T* __restrict__ e1, const T* __restrict__ m1,
                     const T* __restrict__ e2, const T* __restrict__ m2, const T* __restrict__ w,
                     const T* __restrict__ bias, const T* __restrict__ lns, const T* __restrict__ lnb,
                     T* __restrict__ out, int C, int D, float eps, int vact) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int xs = D + kXPad;
  T* x_s = reinterpret_cast<T*>(smem);                                                  // [TM][xs]
  float* h_s = reinterpret_cast<float*>(smem + align128((size_t)TM * xs * sizeof(T)));  // [TM][D]
  const int c0 = blockIdx.x * TM, b = blockIdx.y;
  const int rows = min(TM, C - c0);
  const T* V = v + ((size_t)b * C + c0) * D;
  for (int idx = threadIdx.x; idx < TM * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    T xv = from_f<T>(0.f);
    if (r < rows) {
      const float a1 = to_f(e1[(size_t)b * C + c0 + r]), a2 = to_f(e2[(size_t)b * C + c0 + r]);
      xv = from_f<T>(to_f(V[(size_t)r * D + d]) + a1 * to_f(m1[(size_t)b * D + d]) +
                     a2 * to_f(m2[(size_t)b * D + d]));
    }
    x_s[r * xs + d] = xv;
  }
  __syncthreads();
  TileGemm<T, TM>::run(x_s, xs, w, h_s, D);
  __syncthreads();
  norm_act_rows(h_s, rows, bias, lns, lnb, out + ((size_t)b * C + c0) * D, D, eps, vact);
}

template <typename T, int TM>
int launch_vertex_update(int B, int C, int D, float eps, int vact, const void* v, const void* e1,
                         const void* m1, const void* e2, const void* m2, const void* w,
                         const void* bias, const void* lns, const void* lnb, void* out,
                         cudaStream_t stream) {
  const size_t sm = align128((size_t)TM * (D + kXPad) * sizeof(T)) + (size_t)TM * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(vertex_update_kernel<T, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  vertex_update_kernel<T, TM><<<dim3((C + TM - 1) / TM, B), kThreads, sm, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(e1), static_cast<const T*>(m1),
      static_cast<const T*>(e2), static_cast<const T*>(m2), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(lns), static_cast<const T*>(lnb),
      static_cast<T*>(out), C, D, eps, vact);
  return static_cast<int>(cudaGetLastError());
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

// ===================================================================== bf16
using bf16 = __nv_bfloat16;

enum RowsMode : int { M_ENTITY = 0, M_MENTION = 1, M_VERTEX = 2, M_PROJ_A = 3, M_PROJ_P = 4 };

constexpr int kRT = 64;                          // rows of a block: one wgmma M
constexpr int kBWG = 2;                          // warpgroups: they split the output columns
constexpr int kBThreads = kBWG * kWgThreads;
constexpr int kRingBudget = 232448 - 1024 - 2048 - kTileBytes;  // alignment, x tile, reductions, edges, barriers

// shared memory of gcn_rows_bf16 with kNW output columns per warpgroup:
// the ring of K-slices (the rows' [64, 64] tile, then the W tiles), the x
// tile, the LayerNorm's exchange [2][kBWG][kRT] f32, the tile's edges [2][kRT] f32,
// the ring's barriers
template <int kNW> struct Ring {
  static constexpr int kWTiles = kBWG * kNW / 64;
  static constexpr int kStageBytes = kTileBytes * (1 + kWTiles);
  static constexpr int kFit = kRingBudget / kStageBytes;
  static constexpr int kStages = kFit < DRIN_GCN_STAGES ? kFit : DRIN_GCN_STAGES;
  static constexpr int kOffX = kStages * kStageBytes;  // the x tile [64, 64] bf16, swizzled
  static constexpr int kOffRed = kOffX + kTileBytes;
  static constexpr int kOffE = kOffRed + 2 * kBWG * kRT * 4;
  static constexpr int kOffBars = kOffE + 2 * kRT * 4;
  static constexpr int kSmem = 1024 + kOffBars + kStages * 8;
  static_assert(kStages >= 2, "two K-slices in the ring at least");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct RowsArgs {
  const bf16* u[2];     // mention rows mt, mi [B, D] (vertex update: m1, m2)
  const bf16* e[2][2];  // edges [B * C] by [vertex set][mention] (vertex update: e1, e2 in set 0)
  const bf16* p;        // [B, 2, D] round(p) of the edge fold, or null (static edges)
  const float* s_part;  // [2][B][D / 64] the fold's partial sums of s
  const bf16* bias;     // [D]: b_h (b for the vertex update), bu in A1
  const bf16* lns;      // [D] LayerNorm scale; bv in A1
  const bf16* lnb;      // [D] LayerNorm bias
  bf16* out[2];         // by grid.y: et', ei' | mt', mi' | the update | round(a) [2B, D] | p [B, 2, D]
  bf16* e_out[2][2];    // new edges [B * C] by [set][mention]
  float* msg;           // [2 sets][T][S][2 mentions][D] message slots: B writes them, C reads them
  bf16* xbuf;           // [2B, D] C's x rows, written by B (the workspace of round(a))
  int* count;           // [B] B's tiles done with each b, from 0
  float* s_out;         // A1: [2][B][D / 64]
  int B, C, D, T, S;    // T: row tiles per vertex set; S: slots per tile
  float eps;
  int vact, eact;
};

__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

// acc (+)= af . W for one K-slice of 64: four k-steps, kNJ n64 products
// each, B read from the warpgroup's W tiles at `wt` (K-major, or MN-major
// for kTrans); only enqueued: the caller waits
template <int kNJ, int kTrans>
__device__ __forceinline__ void issue_slice(float (&acc)[kNJ][8][4], const uint32_t (&af)[4][4], uint32_t wt) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j) fence_acc(acc[j]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      wgmma_n64<kTrans>(acc[j], af[kk], tile_desc(wt + j * kTileBytes + (kTrans ? kk * 2048 : kk * 32)), 1);
  wgmma_commit();
}

// rows x W^T (W^T's columns n0 .. n0 + kBWG * kNW) with the epilogue of kMode:
//   M_ENTITY  (launch B) grid (T, 2 sets): x = v + e1*mt + e2*mi, edge dots, message slots, LayerNorm
//   M_MENTION (launch C) grid (ceil(B / 64), 2 mentions): x (formed by launch B), LayerNorm
//   M_VERTEX  (kernel 4) grid (ceil(B*C / 64), 1): x = v + e1*m1 + e2*m2, LayerNorm
//   M_PROJ_A  (launch A1) grid (ceil(B / 64), 2, D / (kBWG*kNW)): a = u.Ku^T + bu, partials of a.bv
//   M_PROJ_P  (launch A2) the same grid: p = round(a).Kv, Kv read MN-major
// a0 / a1: the rows of grid.y 0 / 1 as [rows, D] maps (A2 and C: a0 over [2B, D]);
// wmap: W as a [D, D] map (rows = outputs, or rows = k for A2).
template <int kMode, int kNW, bool kGelu>
__global__ void __launch_bounds__(kBThreads, 1)
gcn_rows_bf16(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
              const __grid_constant__ CUtensorMap wmap, const RowsArgs args) {
  using R = Ring<kNW>;
  constexpr int kNJ = kNW / 64;  // n64 products of a warpgroup per k-step
  constexpr int kTrans = kMode == M_PROJ_P;
  constexpr bool kMix = kMode == M_ENTITY || kMode == M_VERTEX;  // x formed in the slice's prologue
  constexpr bool kNorm = kMix || kMode == M_MENTION;
  // the threads that turn v into x: launch B leaves the first warpgroup to the messages
  constexpr int kConvFirst = kMode == M_ENTITY ? kWgThreads : 0;
  constexpr int kConvIters = kRT * 8 / (kBThreads - kConvFirst);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem), bars = base + R::kOffBars;
  float* red_s = reinterpret_cast<float*>(smem + R::kOffRed);
  float* e_s = reinterpret_cast<float*>(smem + R::kOffE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int set = blockIdx.y, D = args.D, B = args.B, C = args.C, n_k = D / 64;
  const int row0 = blockIdx.x * kRT;
  const int n_rows = kMix ? B * C : B;
  const int rows = min(kRT, n_rows - row0);
  // A2 and C read their rows from one [2B, D] matrix (round(a), or C's x)
  constexpr bool kStacked = kMode == M_PROJ_P || kMode == M_MENTION;
  const int arow = kStacked ? set * B + row0 : row0;
  const CUtensorMap* amap = (kStacked || set == 0) ? &a0 : &a1;
  const int n0 = blockIdx.z * kBWG * kNW;

  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
  }
  if (kMix && tid < 2 * kRT) {  // the edges of the tile's rows, by mention
    const int m = tid / kRT, r = tid % kRT;
    e_s[tid] = r < rows ? to_f(args.e[set][m][row0 + r]) : 0.f;
  }
  __syncthreads();
  auto stage = [&](int i) { return (i % R::kStages) * R::kStageBytes; };  // byte offset
  // one thread: K-slice i (the rows' tile and the W tiles) into its stage
  auto produce = [&](int i) {
    const uint32_t st = base + stage(i), bar = bars + 8 * (i % R::kStages);
    mbar_expect_tx(bar, R::kStageBytes);
    tma_load_2d(st, amap, bar, i * 64, arow);
#pragma unroll 1
    for (int j = 0; j < R::kWTiles; ++j) {
      if (kTrans) tma_load_2d(st + kTileBytes * (1 + j), &wmap, bar, n0 + j * 64, i * 64);
      else tma_load_2d(st + kTileBytes * (1 + j), &wmap, bar, i * 64, n0 + j * 64);
    }
  };
  if (tid == 0)
    for (int i = 0; i < R::kStages && i < n_k; ++i) produce(i);

  // The prologue of K-slice i (kMix): wait for it; launch B's first
  // warpgroup sums e * v into the message slots (a (column, mention) each,
  // walking the rows); the other threads write x = round(v + e1*u1 + e2*u2)
  // into the x tile (same swizzle) and, in launch B, add p.v of their 8
  // columns of each row to the edge dots (dot[q][m], summed over the slices)
  float dot[kConvIters][2];
#pragma unroll
  for (int q = 0; q < kConvIters; ++q) dot[q][0] = dot[q][1] = 0.f;
  const bool dots = kMode == M_ENTITY && args.p != nullptr;
  auto prep = [&](int i) {
    const unsigned char* at = smem + stage(i);
    mbar_wait(bars + 8 * (i % R::kStages), (i / R::kStages) & 1);
    if (!kMix) return;
    if (kMode == M_ENTITY && tid < kConvFirst) {
      const int k = tid % 64, m = tid / 64;
      float* dst = args.msg + ((((size_t)set * args.T + blockIdx.x) * args.S) * 2 + m) * D + i * 64 + k;
      const unsigned char* col = at + (k & 7) * 2;
      const float* e = e_s + m * kRT;
      const int kc = k >> 3;
      int r = 0, end = min(rows, (row0 / C + 1) * C - row0);
      for (float* slot = dst;; slot += (size_t)2 * D) {  // a (b, set) segment at a time
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (; r + 4 <= end; r += 4) {
          s0 += e[r] * to_f(*reinterpret_cast<const bf16*>(col + r * kSwizzleRow + ((kc ^ (r & 7)) << 4)));
          s1 += e[r + 1] * to_f(*reinterpret_cast<const bf16*>(col + (r + 1) * kSwizzleRow + ((kc ^ ((r + 1) & 7)) << 4)));
          s2 += e[r + 2] * to_f(*reinterpret_cast<const bf16*>(col + (r + 2) * kSwizzleRow + ((kc ^ ((r + 2) & 7)) << 4)));
          s3 += e[r + 3] * to_f(*reinterpret_cast<const bf16*>(col + (r + 3) * kSwizzleRow + ((kc ^ ((r + 3) & 7)) << 4)));
        }
        for (; r < end; ++r)
          s0 += e[r] * to_f(*reinterpret_cast<const bf16*>(col + r * kSwizzleRow + ((kc ^ (r & 7)) << 4)));
        *slot = (s0 + s1) + (s2 + s3);
        if (end == rows) break;
        end = min(rows, end + C);
      }
      return;
    }
    const int ct = tid - kConvFirst;
#pragma unroll
    for (int q = 0; q < kConvIters; ++q) {
      const int id = ct + q * (kBThreads - kConvFirst), r = id / 8, pc = id % 8;
      const int k = i * 64 + (pc ^ (r & 7)) * 8;
      uint4 o = make_uint4(0u, 0u, 0u, 0u);  // rows past the end: zeros
      if (r < rows) {
        const int b = (row0 + r) / C;
        float x[8], u1[8], u2[8];
        unpack8(*reinterpret_cast<const uint4*>(at + r * kSwizzleRow + pc * 16), x);
        unpack8(*reinterpret_cast<const uint4*>(args.u[0] + (size_t)b * D + k), u1);
        unpack8(*reinterpret_cast<const uint4*>(args.u[1] + (size_t)b * D + k), u2);
        if (dots) {
          float p0[8], p1[8];
          unpack8(*reinterpret_cast<const uint4*>(args.p + (size_t)b * 2 * D + k), p0);
          unpack8(*reinterpret_cast<const uint4*>(args.p + ((size_t)b * 2 + 1) * D + k), p1);
#pragma unroll
          for (int c = 0; c < 8; ++c) dot[q][0] += p0[c] * x[c], dot[q][1] += p1[c] * x[c];
        }
        const float e1 = e_s[r], e2 = e_s[kRT + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) x[c] = x[c] + e1 * u1[c] + e2 * u2[c];
        o.x = pack_bf16(x[0], x[1]), o.y = pack_bf16(x[2], x[3]);
        o.z = pack_bf16(x[4], x[5]), o.w = pack_bf16(x[6], x[7]);
      }
      *reinterpret_cast<uint4*>(smem + R::kOffX + r * kSwizzleRow + pc * 16) = o;
    }
  };

  float acc[kNJ][8][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[j][f][0] = acc[j][f][1] = acc[j][f][2] = acc[j][f][3] = 0.f;
  uint32_t af[4][4];
  // x comes from the x tile (kMix), else from the ring's rows tile
  const uint32_t x_tile = base + R::kOffX;

  prep(0);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < n_k; ++i) {
    load_a_frags(af, kMix ? x_tile : base + stage(i), wq * 16, lane);
    issue_slice<kNJ, kTrans>(acc, af, base + stage(i) + kTileBytes * (1 + wg * kNJ));
    if (kMix) __syncthreads();  // every warp holds its x fragments: the x tile is free
    if (i + 1 < n_k) prep(i + 1);  // under slice i's products
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kNJ; ++j) fence_acc(acc[j]);
    __syncthreads();  // every warp is done with stage i; slice i + 1 is ready
    if (tid == 0 && i + R::kStages < n_k) produce(i + R::kStages);
  }

  const int rl[2] = {wq * 16 + g, wq * 16 + g + 8};  // this thread's two rows of the tile
  const int cb = n0 + wg * kNW + 2 * t;              // + 64 j + 8 f: its column pairs
  if (dots && tid >= kConvFirst) {                   // the new edges
#pragma unroll
    for (int q = 0; q < kConvIters; ++q) {
      const int r = (tid - kConvFirst + q * (kBThreads - kConvFirst)) / 8;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float d = dot[q][m];
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        if ((lane & 7) == m && r < rows) {
          const int b = (row0 + r) / C, G = D / 64;
          const float* sp = args.s_part + ((size_t)m * B + b) * G;
          float s = 0.f;
          for (int c = 0; c < G; ++c) s += sp[c];  // s: the column tiles' partials, in order
          args.e_out[set][m][row0 + r] = from_f<bf16>(act(args.eact, (d + s) / D + e_s[m * kRT + r]));
        }
      }
    }
  }
  if (kMode == M_ENTITY) {
    // Launch C's x rows.  The last of launch B's blocks to finish with a b
    // (its tiles in both vertex sets; a counter per b says which block is
    // last, so the sums need no atomics) forms x = round(u + msg / C) of
    // both mentions of b from the slots, set 0's tiles then set 1's, in
    // order: the same bits whichever block does it.
    int* last_s = reinterpret_cast<int*>(red_s);  // free until the LayerNorm below
    const int seg0 = row0 / C, n_seg = (row0 + rows - 1) / C - seg0 + 1;
    __threadfence();  // this block's slots, before its count
    __syncthreads();
    if (tid < n_seg) {
      const int b = seg0 + tid;
      const int need = 2 * ((b * C + C - 1) / kRT - b * C / kRT + 1);
      last_s[tid] = atomicAdd(args.count + b, 1) == need - 1 ? b : -1;
    }
    __syncthreads();
    const int chunks = D / 8;
    for (int s = 0; s < n_seg; ++s) {
      const int b = last_s[s];
      if (b < 0) continue;
      __threadfence();  // the other blocks' slots of b, after their counts
      for (int id = tid; id < 2 * chunks; id += kBThreads) {
        const int m = id / chunks, k = (id % chunks) * 8;
        float x[8], msg[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int vs = 0; vs < 2; ++vs)
          for (int tile = b * C / kRT; tile <= (b * C + C - 1) / kRT; ++tile) {
            const float4* src = reinterpret_cast<const float4*>(
                args.msg + ((((size_t)vs * args.T + tile) * args.S + (b - tile * kRT / C)) * 2 + m) * D + k);
            const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
            msg[0] += lo.x, msg[1] += lo.y, msg[2] += lo.z, msg[3] += lo.w;
            msg[4] += hi.x, msg[5] += hi.y, msg[6] += hi.z, msg[7] += hi.w;
          }
        unpack8(*reinterpret_cast<const uint4*>(args.u[m] + (size_t)b * D + k), x);
        uint4 o;
        o.x = pack_bf16(x[0] + msg[0] / C, x[1] + msg[1] / C), o.y = pack_bf16(x[2] + msg[2] / C, x[3] + msg[3] / C);
        o.z = pack_bf16(x[4] + msg[4] / C, x[5] + msg[5] / C), o.w = pack_bf16(x[6] + msg[6] / C, x[7] + msg[7] / C);
        *reinterpret_cast<uint4*>(args.xbuf + ((size_t)m * B + b) * D + k) = o;
      }
    }
    __syncthreads();  // last_s is read before the LayerNorm reuses its words
  }
  if (kNorm) {
    // bias, then the two-pass LayerNorm over the D columns of a row: the
    // quad's four threads, then the two warpgroups through shared memory
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.bias + cb + 64 * j + 8 * f));
        acc[j][f][0] += bb.x, acc[j][f][1] += bb.y, acc[j][f][2] += bb.x, acc[j][f][3] += bb.y;
        sum[0] += acc[j][f][0] + acc[j][f][1];
        sum[1] += acc[j][f][2] + acc[j][f][3];
      }
    float mu[2], rstd[2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        if (t == 0) red_s[(pass * kBWG + wg) * kRT + rl[h]] = sum[h];
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tot = 0.f;
#pragma unroll
        for (int w = 0; w < kBWG; ++w) tot += red_s[(pass * kBWG + w) * kRT + rl[h]];
        if (pass == 0) mu[h] = tot / D;
        else rstd[h] = rsqrtf(tot / D + args.eps);
      }
      if (pass == 0) {
        sum[0] = sum[1] = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            float c;
            c = acc[j][f][0] - mu[0], sum[0] += c * c;
            c = acc[j][f][1] - mu[0], sum[0] += c * c;
            c = acc[j][f][2] - mu[1], sum[1] += c * c;
            c = acc[j][f][3] - mu[1], sum[1] += c * c;
          }
      }
    }
    bf16* out = args.out[set];
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int c = cb + 64 * j + 8 * f;
        const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.lns + c));
        const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.lnb + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rl[h] >= rows) continue;
          // gelu compiled in where it is the activation: a switch at run time,
          // inlined 192 times, cost a fifth of the kernel on the card
          const float z0 = (acc[j][f][2 * h] - mu[h]) * rstd[h] * sc.x + sh.x;
          const float z1 = (acc[j][f][2 * h + 1] - mu[h]) * rstd[h] * sc.y + sh.y;
          const float y0 = kGelu ? act(ACT_GELU, z0) : act(args.vact, z0);
          const float y1 = kGelu ? act(ACT_GELU, z1) : act(args.vact, z1);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + rl[h]) * D + c) = __floats2bfloat162_rn(y0, y1);
        }
      }
  } else if (kMode == M_PROJ_A) {
    // round(a) for A2 (the reference rounds a before Kv^T); s from the unrounded a
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int c = cb + 64 * j + 8 * f;
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.bias + c));
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(args.lns + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = acc[j][f][2 * h] + bb.x, x1 = acc[j][f][2 * h + 1] + bb.y;
          part[h] += x0 * bv.x + x1 * bv.y;
          if (rl[h] < rows)
            *reinterpret_cast<__nv_bfloat162*>(args.out[0] + ((size_t)set * B + row0 + rl[h]) * D + c) =
                __floats2bfloat162_rn(x0, x1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
        if (t == 0 && rl[h] < rows)
          args.s_out[((size_t)set * B + row0 + rl[h]) * (D / 64) + (cb - 2 * t) / 64 + j] = part[h];
      }
    }
  } else {  // M_PROJ_P: p [B, 2, D], rounded
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int f = 0; f < 8; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rl[h] < rows)
            *reinterpret_cast<__nv_bfloat162*>(args.out[0] + ((size_t)(row0 + rl[h]) * 2 + set) * D + cb +
                                               64 * j + 8 * f) =
                __floats2bfloat162_rn(acc[j][f][2 * h], acc[j][f][2 * h + 1]);
  }
}

template <int kMode, int kNW, bool kGelu = false>
int launch_rows(dim3 grid, const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& w,
                const RowsArgs& args, cudaStream_t stream) {
  static const cudaError_t opted = allow_smem(gcn_rows_bf16<kMode, kNW, kGelu>, Ring<kNW>::kSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  gcn_rows_bf16<kMode, kNW, kGelu><<<grid, kBThreads, Ring<kNW>::kSmem, stream>>>(a0, a1, w, args);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kProjNW = DRIN_GCN_PROJ_COLS / kBWG;
static_assert(kProjNW % 64 == 0, "launch A's columns: a multiple of 128");

// the row-wise launches at width D: kNW = D / 2 (D = 128 or 768)
template <int kMode>
int launch_norm(int D, dim3 grid, const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& w,
                const RowsArgs& args, cudaStream_t stream) {
  const bool gelu = args.vact == ACT_GELU;
  if (D == 768)
    return gelu ? launch_rows<kMode, 384, true>(grid, a0, a1, w, args, stream)
                : launch_rows<kMode, 384, false>(grid, a0, a1, w, args, stream);
  if (D == 128)
    return gelu ? launch_rows<kMode, 64, true>(grid, a0, a1, w, args, stream)
                : launch_rows<kMode, 64, false>(grid, a0, a1, w, args, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bf16_width(int D) { return (D == 768 || D == 128) && D % DRIN_GCN_PROJ_COLS == 0; }

}  // namespace

// The bf16 layer, four launches (A1, A2 only for dynamic edges).  Inputs, all
// contiguous bf16: mt, mi [B, D]; et, ei [B, C, D]; tt, ti, it, ii [B, C];
// W_h [D, D] (torch [out, in]); b_h, ln scale, ln bias [D]; Wu, bu, Wv, bv
// (torch layout; unused when dynamic == 0).  Workspace: round(a) [2B, D]
// bf16 (then launch C's x rows), the partials of s [2, B, D / 64] f32, p
// [B, 2, D] bf16, the message slots [2, T, slots, 2, D] f32 with T =
// ceil(B C / 64), a count [B] int32 (zeroed here).  Outputs: mt', mi'
// [B, D]; et', ei' [B, C, D]; tt', ti', it', ii' [B, C] (written only when
// dynamic).  D is 128 or 768.
DRIN_EXPORT int drin_gcn_layer_bf16(int B, int C, int D, float eps, int vact, int eact, int dynamic,
                                    const void* mt, const void* mi, const void* et, const void* ei,
                                    const void* tt, const void* ti, const void* it, const void* ii,
                                    const void* wh, const void* bh, const void* lns, const void* lnb,
                                    const void* wu, const void* bu, const void* wv, const void* bv,
                                    void* ar_ws, void* sp_ws, void* p_ws, void* msg_ws, void* count_ws, int slots,
                                    void* mt_o, void* mi_o, void* et_o, void* ei_o, void* tt_o,
                                    void* ti_o, void* it_o, void* ii_o, void* stream) {
  if (B < 1 || C < 1 || !bf16_width(D) || slots < 1 || (long long)B * C > 0x7fffffffLL / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (B * C + kRT - 1) / kRT, BT = (B + kRT - 1) / kRT;
  CUtensorMap m_mt, m_mi, m_et, m_ei, m_wh;
  int err = matrix_map(&m_mt, mt, B, D);
  if (!err) err = matrix_map(&m_mi, mi, B, D);
  if (!err) err = matrix_map(&m_et, et, B * C, D);
  if (!err) err = matrix_map(&m_ei, ei, B * C, D);
  if (!err) err = matrix_map(&m_wh, wh, D, D);
  if (err) return err;
  RowsArgs a;
  memset(&a, 0, sizeof a);
  a.B = B, a.C = C, a.D = D, a.T = T, a.S = slots, a.eps = eps, a.vact = vact, a.eact = eact;
  if (dynamic) {
    CUtensorMap m_wu, m_wv, m_ar;
    err = matrix_map(&m_wu, wu, D, D);
    if (!err) err = matrix_map(&m_wv, wv, D, D);
    if (!err) err = matrix_map(&m_ar, ar_ws, 2 * B, D);
    if (err) return err;
    const dim3 grid(BT, 2, D / (kBWG * kProjNW));
    RowsArgs pa = a;
    pa.bias = static_cast<const bf16*>(bu), pa.lns = static_cast<const bf16*>(bv);
    pa.out[0] = static_cast<bf16*>(ar_ws), pa.s_out = static_cast<float*>(sp_ws);
    err = launch_rows<M_PROJ_A, kProjNW>(grid, m_mt, m_mi, m_wu, pa, s);
    if (err) return err;
    pa.out[0] = static_cast<bf16*>(p_ws);
    err = launch_rows<M_PROJ_P, kProjNW>(grid, m_ar, m_ar, m_wv, pa, s);
    if (err) return err;
    a.p = static_cast<const bf16*>(p_ws), a.s_part = static_cast<const float*>(sp_ws);
  }
  a.u[0] = static_cast<const bf16*>(mt), a.u[1] = static_cast<const bf16*>(mi);
  a.e[0][0] = static_cast<const bf16*>(tt), a.e[0][1] = static_cast<const bf16*>(it);
  a.e[1][0] = static_cast<const bf16*>(ti), a.e[1][1] = static_cast<const bf16*>(ii);
  a.e_out[0][0] = static_cast<bf16*>(tt_o), a.e_out[0][1] = static_cast<bf16*>(it_o);
  a.e_out[1][0] = static_cast<bf16*>(ti_o), a.e_out[1][1] = static_cast<bf16*>(ii_o);
  a.bias = static_cast<const bf16*>(bh), a.lns = static_cast<const bf16*>(lns), a.lnb = static_cast<const bf16*>(lnb);
  a.msg = static_cast<float*>(msg_ws), a.xbuf = static_cast<bf16*>(ar_ws), a.count = static_cast<int*>(count_ws);
  if (cudaMemsetAsync(count_ws, 0, (size_t)B * sizeof(int), s) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  a.out[0] = static_cast<bf16*>(et_o), a.out[1] = static_cast<bf16*>(ei_o);
  err = launch_norm<M_ENTITY>(D, dim3(T, 2), m_et, m_ei, m_wh, a, s);
  if (err) return err;
  a.out[0] = static_cast<bf16*>(mt_o), a.out[1] = static_cast<bf16*>(mi_o);
  CUtensorMap m_x;  // C's x rows, written by launch B into the workspace of round(a)
  err = matrix_map(&m_x, ar_ws, 2 * B, D);
  if (err) return err;
  return launch_norm<M_MENTION>(D, dim3(BT, 2), m_x, m_x, m_wh, a, s);
}

// The f32 layer (plain FMA): the same inputs; workspace round(a) [2, Bp, D]
// and partial sums [2, Bp, ceil(D/64)] f32 with Bp = B rounded up to 16; p
// [B, 2, D], s [B, 2] f32.  Outputs: et', ei' [B, C, D]; tt', ti', it', ii'
// [B, C] (written only when dynamic); msg [B, 2, 2, D] f32, the raw message
// sums, from which the wrapper finishes the mention updates.
DRIN_EXPORT int drin_gcn_layer_f32(int B, int C, int D, float eps, int vact, int eact, int dynamic,
                                   const void* mt, const void* mi, const void* et, const void* ei,
                                   const void* tt, const void* ti, const void* it, const void* ii,
                                   const void* wh, const void* bh, const void* lns, const void* lnb,
                                   const void* wu, const void* bu, const void* wv, const void* bv,
                                   void* a_ws, void* sp_ws, void* p_ws, void* s_ws, void* et_o,
                                   void* ei_o, void* tt_o, void* ti_o, void* it_o, void* ii_o, void* msg,
                                   void* stream) {
  if (B < 1 || C < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[16] = {mt, mi, et, ei, tt, ti, it, ii, wh, bh, lns, lnb, wu, bu, wv, bv};
  void* out[6] = {et_o, ei_o, tt_o, ti_o, it_o, ii_o};
  return launch<float, 16>(B, C, D, eps, vact, eact, dynamic, in, a_ws, sp_ws, p_ws, s_ws, out, msg,
                           static_cast<cudaStream_t>(stream));
}

// v, out [B, C, D]; e1, e2 [B, C]; m1, m2 [B, D]; w [D, D] (torch [out, in]);
// bias, ln scale, ln bias [D]; all contiguous in the compute type (bf16: D is
// 128 or 768).
DRIN_EXPORT int drin_vertex_update(int dtype, int B, int C, int D, float eps, int vact, const void* v,
                                   const void* e1, const void* m1, const void* e2, const void* m2,
                                   const void* w, const void* bias, const void* lns, const void* lnb,
                                   void* out, void* stream) {
  if (B < 1 || C < 1 || D < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BFLOAT16) {
    if (!bf16_width(D) || (long long)B * C > 0x7fffffffLL / 64) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap m_v, m_w;
    int err = matrix_map(&m_v, v, B * C, D);
    if (!err) err = matrix_map(&m_w, w, D, D);
    if (err) return err;
    RowsArgs a;
    memset(&a, 0, sizeof a);
    a.B = B, a.C = C, a.D = D, a.eps = eps, a.vact = vact;
    a.u[0] = static_cast<const bf16*>(m1), a.u[1] = static_cast<const bf16*>(m2);
    a.e[0][0] = static_cast<const bf16*>(e1), a.e[0][1] = static_cast<const bf16*>(e2);
    a.bias = static_cast<const bf16*>(bias), a.lns = static_cast<const bf16*>(lns);
    a.lnb = static_cast<const bf16*>(lnb), a.out[0] = static_cast<bf16*>(out);
    return launch_norm<M_VERTEX>(D, dim3((B * C + kRT - 1) / kRT, 1), m_v, m_v, m_w, a, s);
  }
  if (dtype == DT_FLOAT32)
    return launch_vertex_update<float, 16>(B, C, D, eps, vact, v, e1, m1, e2, m2, w, bias, lns, lnb,
                                           out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of the bf16 row kernel at `cols` output columns per
// block (768 for the LayerNorm launches at D=768, 128 for the fold) and the
// blocks of launch B's form that share an SM (for the sweep tool and the
// records); negative for a width that is not built
DRIN_EXPORT int drin_gcn_rows_smem(int cols) {
  if (cols == 2 * 384) return Ring<384>::kSmem;
  if (cols == 2 * 64) return Ring<64>::kSmem;
  if (cols == 2 * kProjNW) return Ring<kProjNW>::kSmem;
  return -1;
}
DRIN_EXPORT int drin_gcn_rows_blocks_per_sm(int cols) {
  if (cols == 2 * 384) return blocks_per_sm(gcn_rows_bf16<M_ENTITY, 384, true>, kBThreads, Ring<384>::kSmem);
  if (cols == 2 * 64) return blocks_per_sm(gcn_rows_bf16<M_ENTITY, 64, true>, kBThreads, Ring<64>::kSmem);
  return -1;
}
