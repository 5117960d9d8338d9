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
// the LayerNorm needs the whole 768-wide output row.  The layer is built from
// one piece, the row kernel gcn_rows_bf16 / gcn_rows_f32: rows x W^T with a
// row-wise epilogue.
//   * A block owns 64 rows and all D outputs: two warpgroups of 64 x D/2, the
//     f32 accumulators in registers (192 a thread at D=768).  W arrives in
//     K-slices (all D rows of W) through a TMA / mbarrier ring; the block's 64
//     rows of the same slice come with it.  One elected thread issues the
//     copies.
//   * The rows become wgmma's A operand in the slice's prologue, in place in
//     shared memory (x = round(v + e1*u1 + e2*u2), rounded once as the plain
//     version does) and then from registers; B is read by the tensor cores
//     from the W tiles.  The prologue of slice i+1 runs while the products of
//     slice i are in flight.
//   * The epilogue adds the bias, takes the two-pass LayerNorm in f32 (quad
//     shuffles, then one exchange between the warpgroups in shared memory)
//     and the activation (exact erf gelu), and stores the rows.
// At 64 rows a block each W element is used for 64 rows, so the W slices from
// L2 (W stays resident) set the pace, not the tensor cores.
// The layer is four launches (A1, A2, B, C) with no torch op between them:
//   A1: a = u.Ku^T + bu over the 2B mention rows (blocks of 64 rows x 128
//       columns), round(a) stored, per-64-column partials of a.bv;
//   A2: p = round(a).Kv;
//   B:  the 2BC entity rows, flat, tiles of 64 that never cross from et to ei.
//       The slice's old rows also give the message sums (a (column, mention)
//       per thread walking the rows, written per tile and (b, set) segment
//       into a slot of its own: no atomics, a fixed order) and the edge dots
//       p.v (added up by the threads that form x, over their columns and the
//       K-slices).  The last block to finish with a b (a counter per b) forms
//       launch C's x rows of b, round(u + (the slots, summed in order) / C);
//   C:  the 2B mention rows through the same product and LayerNorm.
// The epilogue has gelu compiled in (the other activations switch at run
// time).
//
// bf16 (gcn_rows_bf16): K-slices of 64, W as [64, 64] tiles by TMA,
// 128-byte swizzled; wgmma m64n64k16 with A from registers (ldmatrix of the
// x tile); A2 reads Kv MN-major.
//
// float32 (gcn_rows_f32): every product on the tensor cores in split-precision
// TF32 (hopper.cuh: x = hi + lo, each cvt.rna-rounded; lo.hi + hi.lo + hi.hi
// in f32 accumulators), wgmma m64n64k8 with A's split fragments in registers.
//   * W is split once per call, not once per block: split_w_f32, a small
//     elementwise launch at the start of the layer, writes W_h's hi and lo
//     (and, with dynamic edges, Ku's and Kv's) into the workspace as the
//     ring's image of each K-slice, so a slice is two contiguous bulk copies.
//     Kv's image holds Kv^T: A2's product sums over Kv's rows, and .tf32
//     reads B only K-major.  Splitting in shared memory beside the tensor
//     cores would cost every one of launch B's blocks the same work.
//   * Shared memory is the limit: a slice of hi + lo for all D=768 outputs is
//     6 KB per column.  K-slices of 16 columns, one 64-byte swizzle row per
//     output (hi 48 KB + lo 48 KB + the rows' 4 KB a stage), two stages.
//   * The rows' f32 slice stays raw in the ring (the message sums and edge
//     dots need the old values); x is formed in f32 into the x tile (no
//     rounding) and split into A fragments in registers.
//   * Launch B streams W hi + lo, 4.7 MB at D=768, from L2 for every 64 rows:
//     ~0.95 GB of L2 reads over its 202 blocks against ~0.1 ms of TF32 tensor
//     work, so L2 bandwidth, not the tensor cores, sets its pace.
//
// The same file holds the port of drin_tpu/ops/pallas/gcn.py::
// fused_vertex_update: the row kernel over the B*C rows without the edge dots
// and the messages (M_VERTEX).

#include <type_traits>

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

using bf16 = __nv_bfloat16;

enum RowsMode : int { M_ENTITY = 0, M_MENTION = 1, M_VERTEX = 2, M_PROJ_A = 3, M_PROJ_P = 4 };

constexpr int kRT = 64;                          // rows of a block: one wgmma M
constexpr int kBWG = 2;                          // warpgroups: they split the output columns
constexpr int kBThreads = kBWG * kWgThreads;
constexpr int kF32K = 16;                        // f32: columns of a K-slice, one 64-byte swizzle row

// Shared memory of the row kernel in element type E with kNW output columns
// per warpgroup: the ring of K-slices, the x tile, the LayerNorm's exchange
// [2][kBWG][kRT] f32, the tile's edges [2][kRT] f32, f32 only the epilogue's
// vectors (bias, LayerNorm scale and bias of the block's columns), the ring's
// barriers.  A stage holds the rows' tile, then W's tiles: bf16 [64, 64]
// tiles (rows = outputs) 128-byte swizzled; f32 the slice's split image, hi
// for every output then lo, one 64-byte-swizzled row of 16 columns per
// output.
template <typename E, int kNW> struct Ring {
  static constexpr bool kF32 = std::is_same<E, float>::value;
  static constexpr int kK = kF32 ? kF32K : 64;                   // columns of a K-slice
  static constexpr int kRowBytes = kK * (int)sizeof(E);          // one swizzle row
  static constexpr int kRowsBytes = kRT * kRowBytes;             // the rows' tile (and the x tile)
  static constexpr int kWBytes = kBWG * kNW * kRowBytes;         // W's tiles (f32: its hi, then as much lo)
  static constexpr int kStageBytes = kRowsBytes + (kF32 ? 2 : 1) * kWBytes;
  static constexpr int kParamBytes = kF32 ? 3 * kBWG * kNW * 4 : 0;
  static constexpr int kFit = (232448 - 1024 - 2048 - kRowsBytes - kParamBytes) / kStageBytes;
  static constexpr int kStages = kFit < DRIN_GCN_STAGES ? kFit : DRIN_GCN_STAGES;
  static constexpr int kOffX = kStages * kStageBytes;
  static constexpr int kOffRed = kOffX + kRowsBytes;
  static constexpr int kOffE = kOffRed + 2 * kBWG * kRT * 4;
  static constexpr int kOffP = kOffE + 2 * kRT * 4;  // f32: bias, ln scale, ln bias of the block's columns
  static constexpr int kOffBars = kOffP + kParamBytes;
  static constexpr int kSmem = 1024 + kOffBars + kStages * 8;
  static_assert(kStages >= 2, "two K-slices in the ring at least");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <typename E> struct RowsArgs {
  const E* u[2];        // mention rows mt, mi [B, D] (vertex update: m1, m2)
  const E* e[2][2];     // edges [B * C] by [vertex set][mention] (vertex update: e1, e2 in set 0)
  const E* p;           // [B, 2, D] round(p) of the edge fold, or null (static edges)
  const float* s_part;  // [2][B][D / 64] the fold's partial sums of s
  const E* bias;        // [D]: b_h (b for the vertex update), bu in A1
  const E* lns;         // [D] LayerNorm scale; bv in A1
  const E* lnb;         // [D] LayerNorm bias
  E* out[2];            // by grid.y: et', ei' | mt', mi' | the update | round(a) [2B, D] | p [B, 2, D]
  E* e_out[2][2];       // new edges [B * C] by [set][mention]
  float* msg;           // [2 sets][T][S][2 mentions][D] message slots: B writes them, C reads them
  E* xbuf;              // [2B, D] C's x rows, written by B (the workspace of round(a))
  int* count;           // [B] B's tiles done with each b, from 0
  float* s_out;         // A1: [2][B][D / 64]
  const float* w;       // f32: W's split image [D / 16][2][D][16] (split_w_f32; A2: Kv^T's)
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

// 16 bytes of a row as floats (8 bf16 or 4 f32), and back in the element type
template <typename E> struct Chunk;
template <> struct Chunk<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const void* p, float (&f)[8]) {
    unpack8(*reinterpret_cast<const uint4*>(p), f);
  }
  static __device__ __forceinline__ void store(void* p, const float (&f)[8]) {
    uint4 o;
    o.x = pack_bf16(f[0], f[1]), o.y = pack_bf16(f[2], f[3]);
    o.z = pack_bf16(f[4], f[5]), o.w = pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(p) = o;
  }
};
template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const void* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  static __device__ __forceinline__ void store(void* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// two neighbouring values as floats, and back in the element type
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The swizzle of a tile row: the 16-byte chunk that chunk pc of row r holds
// (and where chunk pc of row r lies).  bf16 rows of 128 bytes: pc ^ (r % 8);
// f32 rows of 64 bytes: pc ^ (r / 2 % 4).
template <typename E> __device__ __forceinline__ int swz(int r, int pc) {
  return sizeof(E) == 4 ? (pc ^ (r >> 1)) & 3 : pc ^ (r & 7);
}
// byte offset of element (r, c) of a swizzled [rows, K-slice] tile
template <typename E> __device__ __forceinline__ int tile_at(int r, int c) {
  constexpr int per = 16 / (int)sizeof(E), row = sizeof(E) == 4 ? 64 : kSwizzleRow;
  return r * row + (swz<E>(r, c / per) << 4) + (c % per) * (int)sizeof(E);
}

// acc (+)= af . W for one bf16 K-slice of 64: four k-steps, kNJ n64 products
// each, B read from the warpgroup's W tiles at `wt` (K-major, or MN-major for
// kTrans); only enqueued: the caller waits
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

// x's split A fragments (hi and lo) of rows r0 .. r0 + 15 of an f32 [64, 16]
// tile: two k-steps of 8 columns (wgmma_tf32_n64's layout)
__device__ __forceinline__ void load_split_frags16(uint32_t (&hi)[2][4], uint32_t (&lo)[2][4],
                                                   const unsigned char* tile, int r0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = *reinterpret_cast<const float*>(tile + tile_at<float>(r0 + g + (i & 1) * 8, kk * 8 + t + (i >> 1) * 4));
      float h, l;
      split_tf32(x, h, l);
      hi[kk][i] = __float_as_uint(h);
      lo[kk][i] = __float_as_uint(l);
    }
}

// acc (+)= x . W for one f32 K-slice of 16 in split precision: two k-steps,
// kNJ n64 products of three TF32 passes each, B read from the warpgroup's
// rows of W's hi and lo images (64 bytes an output, K-major); only enqueued
template <int kNJ>
__device__ __forceinline__ void issue_slice_f32(float (&acc)[kNJ][8][4], uint32_t (&ahi)[2][4], uint32_t (&alo)[2][4],
                                                uint32_t whi, uint32_t wlo) {
#pragma unroll
  for (int j = 0; j < kNJ; ++j) fence_acc(acc[j]);
  fence_frags(ahi);
  fence_frags(alo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const uint32_t off = j * 64 * 64 + kk * 32;
      wgmma_tf32_split(acc[j], ahi[kk], alo[kk], tile_desc<64>(whi + off), tile_desc<64>(wlo + off), 1);
    }
  wgmma_commit();
}

// rows x W^T (W^T's columns n0 .. n0 + kBWG * kNW) with the epilogue of kMode:
//   M_ENTITY  (launch B) grid (T, 2 sets): x = v + e1*mt + e2*mi, edge dots, message slots, LayerNorm
//   M_MENTION (launch C) grid (ceil(B / 64), 2 mentions): x (formed by launch B), LayerNorm
//   M_VERTEX  (kernel 4) grid (ceil(B*C / 64), 1): x = v + e1*m1 + e2*m2, LayerNorm
//   M_PROJ_A  (launch A1) grid (ceil(B / 64), 2, D / (kBWG*kNW)): a = u.Ku^T + bu, partials of a.bv
//   M_PROJ_P  (launch A2) the same grid: p = round(a).Kv (bf16: Kv read MN-major; f32: Kv^T's image)
// a0 / a1: the rows of grid.y 0 / 1 as [rows, D] maps (A2 and C: a0 over [2B, D]);
// wmap (bf16): W as a [D, D] map (rows = outputs, or rows = k for A2); f32: args.w.
template <typename E, int kMode, int kNW, bool kGelu>
__device__ __forceinline__ void rows_body(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& wmap,
                                          const RowsArgs<E>& args) {
  using R = Ring<E, kNW>;
  constexpr bool kF32 = R::kF32;
  constexpr int kNJ = kNW / 64;  // n64 products of a warpgroup per k-step
  constexpr int kTrans = kMode == M_PROJ_P && !kF32;
  constexpr bool kMix = kMode == M_ENTITY || kMode == M_VERTEX;  // x formed in the slice's prologue
  constexpr bool kNorm = kMix || kMode == M_MENTION;
  constexpr int kPer = Chunk<E>::N;              // elements of a 16-byte chunk
  constexpr int kCPR = R::kRowBytes / 16;        // chunks of a tile row
  constexpr int kChunks = kRT * kCPR;
  // the threads that turn v into x: launch B leaves the first warpgroup (bf16)
  // or warp (f32: 16 columns a slice) to the messages
  constexpr int kConvFirst = kMode == M_ENTITY ? (kF32 ? 32 : kWgThreads) : 0;
  constexpr int kConv = kBThreads - kConvFirst;
  constexpr int kConvIters = (kChunks + kConv - 1) / kConv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem), bars = base + R::kOffBars;
  float* red_s = reinterpret_cast<float*>(smem + R::kOffRed);
  float* e_s = reinterpret_cast<float*>(smem + R::kOffE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int set = blockIdx.y, D = args.D, B = args.B, C = args.C, n_k = D / R::kK;
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
  // the epilogue's vectors: f32 reads them from shared memory, which takes
  // the spills out of the D=768 gelu launches (their float2 loads, hoisted
  // beside 192 accumulators, ran over 255 registers); bf16 from global memory
  const E* bias = args.bias;
  const E* lns = args.lns;
  const E* lnb = args.lnb;
  if constexpr (kF32) {
    constexpr int N = kBWG * kNW;
    float* p_s = reinterpret_cast<float*>(smem + R::kOffP);
    for (int c = tid; c < N; c += kBThreads) {
      if (args.bias) p_s[c] = to_f(args.bias[n0 + c]);
      if (args.lns) p_s[N + c] = to_f(args.lns[n0 + c]);
      if (args.lnb) p_s[2 * N + c] = to_f(args.lnb[n0 + c]);
    }
    bias = reinterpret_cast<const E*>(p_s) - n0;
    lns = bias + N, lnb = bias + 2 * N;
  }
  __syncthreads();
  auto stage = [&](int i) { return (i % R::kStages) * R::kStageBytes; };  // byte offset
  // one thread: K-slice i (the rows' tile and the W tiles) into its stage
  auto produce = [&](int i) {
    const uint32_t st = base + stage(i), bar = bars + 8 * (i % R::kStages);
    mbar_expect_tx(bar, R::kStageBytes);
    tma_load_2d(st, amap, bar, i * R::kK, arow);
    if constexpr (kF32) {
      const float* w = args.w + ((size_t)i * 2 * D + n0) * kF32K;
      bulk_load(st + R::kRowsBytes, w, R::kWBytes, bar);
      bulk_load(st + R::kRowsBytes + R::kWBytes, w + (size_t)D * kF32K, R::kWBytes, bar);
    } else {
#pragma unroll 1
      for (int j = 0; j < R::kWBytes / kTileBytes; ++j) {
        if (kTrans) tma_load_2d(st + kTileBytes * (1 + j), &wmap, bar, n0 + j * 64, i * 64);
        else tma_load_2d(st + kTileBytes * (1 + j), &wmap, bar, i * 64, n0 + j * 64);
      }
    }
  };
  if (tid == 0)
    for (int i = 0; i < R::kStages && i < n_k; ++i) produce(i);

  // The prologue of K-slice i (kMix): wait for it; launch B's message threads
  // sum e * v into the message slots (a (column, mention) each, walking the
  // rows); the other threads write x = round(v + e1*u1 + e2*u2) into the x
  // tile (same swizzle) and, in launch B, add p.v of their chunk's columns of
  // each row to the edge dots (dot[q][m], summed over the slices)
  float dot[kConvIters][2];
#pragma unroll
  for (int q = 0; q < kConvIters; ++q) dot[q][0] = dot[q][1] = 0.f;
  const bool dots = kMode == M_ENTITY && args.p != nullptr;
  auto prep = [&](int i) {
    const unsigned char* at = smem + stage(i);
    mbar_wait(bars + 8 * (i % R::kStages), (i / R::kStages) & 1);
    if (!kMix) return;
    if (kMode == M_ENTITY && tid < kConvFirst) {
      const int k = tid % R::kK, m = tid / R::kK;
      float* dst = args.msg + ((((size_t)set * args.T + blockIdx.x) * args.S) * 2 + m) * D + i * R::kK + k;
      const float* e = e_s + m * kRT;
      auto v = [&](int r) { return to_f(*reinterpret_cast<const E*>(at + tile_at<E>(r, k))); };
      int r = 0, end = min(rows, (row0 / C + 1) * C - row0);
      for (float* slot = dst;; slot += (size_t)2 * D) {  // a (b, set) segment at a time
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (; r + 4 <= end; r += 4) {
          s0 += e[r] * v(r);
          s1 += e[r + 1] * v(r + 1);
          s2 += e[r + 2] * v(r + 2);
          s3 += e[r + 3] * v(r + 3);
        }
        for (; r < end; ++r) s0 += e[r] * v(r);
        *slot = (s0 + s1) + (s2 + s3);
        if (end == rows) break;
        end = min(rows, end + C);
      }
      return;
    }
    const int ct = tid - kConvFirst;
#pragma unroll
    for (int q = 0; q < kConvIters; ++q) {
      const int id = ct + q * kConv, r = id / kCPR, pc = id % kCPR;
      if (kChunks % kConv != 0 && id >= kChunks) break;  // f32 launch B: a whole warp
      const int k = i * R::kK + swz<E>(r, pc) * kPer;
      float x[kPer];
#pragma unroll
      for (int c = 0; c < kPer; ++c) x[c] = 0.f;  // rows past the end: zeros
      if (r < rows) {
        const int b = (row0 + r) / C;
        float u1[kPer], u2[kPer];
        Chunk<E>::load(at + r * R::kRowBytes + pc * 16, x);
        Chunk<E>::load(args.u[0] + (size_t)b * D + k, u1);
        Chunk<E>::load(args.u[1] + (size_t)b * D + k, u2);
        if (dots) {
          float p0[kPer], p1[kPer];
          Chunk<E>::load(args.p + (size_t)b * 2 * D + k, p0);
          Chunk<E>::load(args.p + ((size_t)b * 2 + 1) * D + k, p1);
#pragma unroll
          for (int c = 0; c < kPer; ++c) dot[q][0] += p0[c] * x[c], dot[q][1] += p1[c] * x[c];
        }
        const float e1 = e_s[r], e2 = e_s[kRT + r];
#pragma unroll
        for (int c = 0; c < kPer; ++c) x[c] = x[c] + e1 * u1[c] + e2 * u2[c];
      }
      Chunk<E>::store(smem + R::kOffX + r * R::kRowBytes + pc * 16, x);
    }
  };

  float acc[kNJ][8][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[j][f][0] = acc[j][f][1] = acc[j][f][2] = acc[j][f][3] = 0.f;
  // x comes from the x tile (kMix), else from the ring's rows tile
  const uint32_t x_tile = base + R::kOffX;

  prep(0);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < n_k; ++i) {
    const uint32_t a_tile = kMix ? x_tile : base + stage(i);
    const uint32_t w_tile = base + stage(i) + R::kRowsBytes + wg * kNW * R::kRowBytes;
    if constexpr (kF32) {
      uint32_t ahi[2][4], alo[2][4];
      load_split_frags16(ahi, alo, smem + (a_tile - base), wq * 16, lane);
      issue_slice_f32<kNJ>(acc, ahi, alo, w_tile, w_tile + R::kWBytes);
    } else {
      uint32_t af[4][4];
      load_a_frags(af, a_tile, wq * 16, lane);
      issue_slice<kNJ, kTrans>(acc, af, w_tile);
    }
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
      const int id = tid - kConvFirst + q * kConv, r = id / kCPR;
      if (kChunks % kConv != 0 && id >= kChunks) break;  // a whole warp, as in prep
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float d = dot[q][m];
#pragma unroll
        for (int o = 1; o < kCPR; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if ((lane & (kCPR - 1)) == m && r < rows) {
          const int b = (row0 + r) / C, G = D / 64;
          const float* sp = args.s_part + ((size_t)m * B + b) * G;
          float s = 0.f;
          for (int c = 0; c < G; ++c) s += sp[c];  // s: the column tiles' partials, in order
          args.e_out[set][m][row0 + r] = from_f<E>(act(args.eact, (d + s) / D + e_s[m * kRT + r]));
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
    const int chunks = D / kPer;
    for (int s = 0; s < n_seg; ++s) {
      const int b = last_s[s];
      if (b < 0) continue;
      __threadfence();  // the other blocks' slots of b, after their counts
      for (int id = tid; id < 2 * chunks; id += kBThreads) {
        const int m = id / chunks, k = (id % chunks) * kPer;
        float x[kPer], msg[kPer];
#pragma unroll
        for (int c = 0; c < kPer; ++c) msg[c] = 0.f;
        for (int vs = 0; vs < 2; ++vs)
          for (int tile = b * C / kRT; tile <= (b * C + C - 1) / kRT; ++tile) {
            const float4* src = reinterpret_cast<const float4*>(
                args.msg + ((((size_t)vs * args.T + tile) * args.S + (b - tile * kRT / C)) * 2 + m) * D + k);
#pragma unroll
            for (int h = 0; h < kPer / 4; ++h) {
              const float4 v = __ldcg(src + h);
              msg[4 * h] += v.x, msg[4 * h + 1] += v.y, msg[4 * h + 2] += v.z, msg[4 * h + 3] += v.w;
            }
          }
        Chunk<E>::load(args.u[m] + (size_t)b * D + k, x);
#pragma unroll
        for (int c = 0; c < kPer; ++c) x[c] = x[c] + msg[c] / C;
        Chunk<E>::store(args.xbuf + ((size_t)m * B + b) * D + k, x);
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
        const float2 bb = load2(bias + cb + 64 * j + 8 * f);
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
    E* out = args.out[set];
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int c = cb + 64 * j + 8 * f;
        const float2 sc = load2(lns + c);
        const float2 sh = load2(lnb + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rl[h] >= rows) continue;
          // gelu compiled in where it is the activation: a switch at run time,
          // inlined 192 times, cost a fifth of the kernel on the card
          const float z0 = (acc[j][f][2 * h] - mu[h]) * rstd[h] * sc.x + sh.x;
          const float z1 = (acc[j][f][2 * h + 1] - mu[h]) * rstd[h] * sc.y + sh.y;
          const float y0 = kGelu ? act(ACT_GELU, z0) : act(args.vact, z0);
          const float y1 = kGelu ? act(ACT_GELU, z1) : act(args.vact, z1);
          store2(out + (size_t)(row0 + rl[h]) * D + c, y0, y1);
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
        const float2 bb = load2(bias + c);
        const float2 bv = load2(lns + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = acc[j][f][2 * h] + bb.x, x1 = acc[j][f][2 * h + 1] + bb.y;
          part[h] += x0 * bv.x + x1 * bv.y;
          if (rl[h] < rows) store2(args.out[0] + ((size_t)set * B + row0 + rl[h]) * D + c, x0, x1);
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
            store2(args.out[0] + ((size_t)(row0 + rl[h]) * 2 + set) * D + cb + 64 * j + 8 * f,
                   acc[j][f][2 * h], acc[j][f][2 * h + 1]);
  }
}

template <int kMode, int kNW, bool kGelu>
__global__ void __launch_bounds__(kBThreads, 1)
gcn_rows_bf16(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
              const __grid_constant__ CUtensorMap wmap, const RowsArgs<bf16> args) {
  rows_body<bf16, kMode, kNW, kGelu>(a0, a1, wmap, args);
}

template <int kMode, int kNW, bool kGelu>
__global__ void __launch_bounds__(kBThreads, 1)
gcn_rows_f32(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
             const __grid_constant__ CUtensorMap wmap, const RowsArgs<float> args) {
  rows_body<float, kMode, kNW, kGelu>(a0, a1, wmap, args);
}

// W's split image for gcn_rows_f32: each matrix W [D, D] (torch [out, in];
// with trans its transpose, Kv^T) as [D / 16][2][D][16] f32: K-slice i, hi |
// lo, output n, the slice's 16 columns in a 64-byte-swizzled row, so that a
// stage of the ring is two contiguous copies.  grid (D * D / 4 / 256, matrices).
struct SplitArgs {
  const float* w[3];
  float* img[3];
  int trans[3];
};

__global__ void __launch_bounds__(256) split_w_f32(const SplitArgs a, int D) {
  const int m = blockIdx.y, idx = blockIdx.x * 256 + threadIdx.x;  // (i, n, chunk c), c fastest
  if (idx >= D * D / 4) return;
  const int c = idx & 3, n = (idx >> 2) % D, k = (idx >> 2) / D * kF32K + c * 4;
  // the matrix by selects, not by indexing the parameter (which copies it to the stack)
  const float* src = m == 0 ? a.w[0] : m == 1 ? a.w[1] : a.w[2];
  float* img = m == 0 ? a.img[0] : m == 1 ? a.img[1] : a.img[2];
  const bool trans = m == 0 ? a.trans[0] : m == 1 ? a.trans[1] : a.trans[2];
  float4 x;
  if (trans) {
    const float* w = src + (size_t)k * D + n;
    x = make_float4(w[0], w[D], w[2 * D], w[3 * D]);
  } else {
    x = *reinterpret_cast<const float4*>(src + (size_t)n * D + k);
  }
  float4 hi, lo;
  split_tf32(x, hi, lo);
  float* dst = img + ((size_t)(k / kF32K) * 2 * D + n) * kF32K + (((c ^ (n >> 1)) & 3) << 2);
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + (size_t)D * kF32K) = lo;
}

int split_weights(const SplitArgs& a, int n, int D, cudaStream_t stream) {
  split_w_f32<<<dim3((D * D / 4 + 255) / 256, n), 256, 0, stream>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int kMode, int kNW, bool kGelu = false>
int launch_rows(dim3 grid, const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& w,
                const RowsArgs<E>& args, cudaStream_t stream) {
  constexpr int smem = Ring<E, kNW>::kSmem;
  if constexpr (std::is_same<E, float>::value) {
    static const cudaError_t opted = allow_smem(gcn_rows_f32<kMode, kNW, kGelu>, smem);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    gcn_rows_f32<kMode, kNW, kGelu><<<grid, kBThreads, smem, stream>>>(a0, a1, w, args);
  } else {
    static const cudaError_t opted = allow_smem(gcn_rows_bf16<kMode, kNW, kGelu>, smem);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    gcn_rows_bf16<kMode, kNW, kGelu><<<grid, kBThreads, smem, stream>>>(a0, a1, w, args);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kProjNW = DRIN_GCN_PROJ_COLS / kBWG;
static_assert(kProjNW % 64 == 0, "launch A's columns: a multiple of 128");

// the row-wise launches at width D: kNW = D / 2 (D = 128 or 768)
template <typename E, int kMode>
int launch_norm(int D, dim3 grid, const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& w,
                const RowsArgs<E>& args, cudaStream_t stream) {
  const bool gelu = args.vact == ACT_GELU;
  if (D == 768)
    return gelu ? launch_rows<E, kMode, 384, true>(grid, a0, a1, w, args, stream)
                : launch_rows<E, kMode, 384, false>(grid, a0, a1, w, args, stream);
  if (D == 128)
    return gelu ? launch_rows<E, kMode, 64, true>(grid, a0, a1, w, args, stream)
                : launch_rows<E, kMode, 64, false>(grid, a0, a1, w, args, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool built_width(int D) { return (D == 768 || D == 128) && D % DRIN_GCN_PROJ_COLS == 0; }

// The layer in element type E: in = mt, mi, et, ei, tt, ti, it, ii, wh, bh,
// lns, lnb, wu, bu, wv, bv; out = mt', mi', et', ei', tt', ti', it', ii';
// split (f32 only) = the images of W_h, Ku and Kv^T.
template <typename E>
int gcn_layer(int B, int C, int D, float eps, int vact, int eact, int dynamic, const void* const* in,
              void* ar_ws, void* sp_ws, void* p_ws, void* msg_ws, void* count_ws, int slots,
              float* const* split, void* const* out, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<E, float>::value;
  if (B < 1 || C < 1 || !built_width(D) || slots < 1 || (long long)B * C > 0x7fffffffLL / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (B * C + kRT - 1) / kRT, BT = (B + kRT - 1) / kRT;
  const E* const* w = reinterpret_cast<const E* const*>(in + 8);  // wh, bh, lns, lnb, wu, bu, wv, bv
  CUtensorMap m_mt, m_mi, m_et, m_ei, m_wh;
  int err = matrix_map<E>(&m_mt, in[0], B, D);
  if (!err) err = matrix_map<E>(&m_mi, in[1], B, D);
  if (!err) err = matrix_map<E>(&m_et, in[2], B * C, D);
  if (!err) err = matrix_map<E>(&m_ei, in[3], B * C, D);
  if (!err) err = kF32 ? 0 : matrix_map<E>(&m_wh, w[0], D, D);  // f32 reads W's split image
  if (err) return err;
  if (kF32) {
    m_wh = m_mt;  // not read
    SplitArgs sa;
    memset(&sa, 0, sizeof sa);
    const void* mats[3] = {w[0], w[4], w[6]};
    for (int m = 0; m < 3; ++m)
      sa.w[m] = static_cast<const float*>(mats[m]), sa.img[m] = split[m], sa.trans[m] = m == 2;
    err = split_weights(sa, dynamic ? 3 : 1, D, s);
    if (err) return err;
  }
  RowsArgs<E> a;
  memset(&a, 0, sizeof a);
  a.B = B, a.C = C, a.D = D, a.T = T, a.S = slots, a.eps = eps, a.vact = vact, a.eact = eact;
  if (dynamic) {
    CUtensorMap m_wu, m_wv, m_ar;
    err = matrix_map<E>(&m_ar, ar_ws, 2 * B, D);
    if (!err) err = kF32 ? 0 : matrix_map<E>(&m_wu, w[4], D, D);
    if (!err) err = kF32 ? 0 : matrix_map<E>(&m_wv, w[6], D, D);
    if (err) return err;
    if (kF32) m_wu = m_wv = m_ar;  // not read
    const dim3 grid(BT, 2, D / (kBWG * kProjNW));
    RowsArgs<E> pa = a;
    pa.bias = w[5], pa.lns = w[7];
    pa.out[0] = static_cast<E*>(ar_ws), pa.s_out = static_cast<float*>(sp_ws);
    pa.w = kF32 ? split[1] : nullptr;
    err = launch_rows<E, M_PROJ_A, kProjNW>(grid, m_mt, m_mi, m_wu, pa, s);
    if (err) return err;
    pa.out[0] = static_cast<E*>(p_ws);
    pa.w = kF32 ? split[2] : nullptr;
    err = launch_rows<E, M_PROJ_P, kProjNW>(grid, m_ar, m_ar, m_wv, pa, s);
    if (err) return err;
    a.p = static_cast<const E*>(p_ws), a.s_part = static_cast<const float*>(sp_ws);
  }
  const E* const* v = reinterpret_cast<const E* const*>(in);
  a.u[0] = v[0], a.u[1] = v[1];
  a.e[0][0] = v[4], a.e[0][1] = v[6], a.e[1][0] = v[5], a.e[1][1] = v[7];  // (tt, it) with et, (ti, ii) with ei
  E* const* o = reinterpret_cast<E* const*>(out);
  a.e_out[0][0] = o[4], a.e_out[0][1] = o[6], a.e_out[1][0] = o[5], a.e_out[1][1] = o[7];
  a.bias = w[1], a.lns = w[2], a.lnb = w[3];
  a.w = kF32 ? split[0] : nullptr;
  a.msg = static_cast<float*>(msg_ws), a.xbuf = static_cast<E*>(ar_ws), a.count = static_cast<int*>(count_ws);
  if (cudaMemsetAsync(count_ws, 0, (size_t)B * sizeof(int), s) != cudaSuccess) return static_cast<int>(cudaGetLastError());
  a.out[0] = o[2], a.out[1] = o[3];
  err = launch_norm<E, M_ENTITY>(D, dim3(T, 2), m_et, m_ei, m_wh, a, s);
  if (err) return err;
  a.out[0] = o[0], a.out[1] = o[1];
  CUtensorMap m_x;  // C's x rows, written by launch B into the workspace of round(a)
  err = matrix_map<E>(&m_x, ar_ws, 2 * B, D);
  if (err) return err;
  return launch_norm<E, M_MENTION>(D, dim3(BT, 2), m_x, m_x, m_wh, a, s);
}

}  // namespace

// The layer, four launches (A1, A2 only for dynamic edges) and a memset; in
// float32 a first launch splits the weights.  Inputs, all contiguous in the
// compute type: mt, mi [B, D]; et, ei [B, C, D]; tt, ti, it, ii [B, C]; W_h
// [D, D] (torch [out, in]); b_h, ln scale, ln bias [D]; Wu, bu, Wv, bv (torch
// layout; unused when dynamic == 0).  Workspace: round(a) [2B, D] in the
// compute type (then launch C's x rows), the partials of s [2, B, D / 64]
// f32, p [B, 2, D], the message slots [2, T, slots, 2, D] f32 with T =
// ceil(B C / 64), a count [B] int32 (zeroed here).  Outputs: mt', mi' [B,
// D]; et', ei' [B, C, D]; tt', ti', it', ii' [B, C] (written only when
// dynamic).  D is 128 or 768.
DRIN_EXPORT int drin_gcn_layer_bf16(int B, int C, int D, float eps, int vact, int eact, int dynamic,
                                    const void* mt, const void* mi, const void* et, const void* ei,
                                    const void* tt, const void* ti, const void* it, const void* ii,
                                    const void* wh, const void* bh, const void* lns, const void* lnb,
                                    const void* wu, const void* bu, const void* wv, const void* bv,
                                    void* ar_ws, void* sp_ws, void* p_ws, void* msg_ws, void* count_ws, int slots,
                                    void* mt_o, void* mi_o, void* et_o, void* ei_o, void* tt_o,
                                    void* ti_o, void* it_o, void* ii_o, void* stream) {
  const void* in[16] = {mt, mi, et, ei, tt, ti, it, ii, wh, bh, lns, lnb, wu, bu, wv, bv};
  void* out[8] = {mt_o, mi_o, et_o, ei_o, tt_o, ti_o, it_o, ii_o};
  return gcn_layer<bf16>(B, C, D, eps, vact, eact, dynamic, in, ar_ws, sp_ws, p_ws, msg_ws, count_ws, slots,
                         nullptr, out, static_cast<cudaStream_t>(stream));
}

// The float32 layer: the same arguments, and the split images of W_h, Ku and
// Kv^T, [D / 16, 2, D, 16] f32 each (written here; Ku's and Kv's only when
// dynamic).
DRIN_EXPORT int drin_gcn_layer_f32(int B, int C, int D, float eps, int vact, int eact, int dynamic,
                                   const void* mt, const void* mi, const void* et, const void* ei,
                                   const void* tt, const void* ti, const void* it, const void* ii,
                                   const void* wh, const void* bh, const void* lns, const void* lnb,
                                   const void* wu, const void* bu, const void* wv, const void* bv,
                                   void* ar_ws, void* sp_ws, void* p_ws, void* msg_ws, void* count_ws, int slots,
                                   void* wh_s, void* wu_s, void* wv_s, void* mt_o, void* mi_o, void* et_o,
                                   void* ei_o, void* tt_o, void* ti_o, void* it_o, void* ii_o, void* stream) {
  const void* in[16] = {mt, mi, et, ei, tt, ti, it, ii, wh, bh, lns, lnb, wu, bu, wv, bv};
  void* out[8] = {mt_o, mi_o, et_o, ei_o, tt_o, ti_o, it_o, ii_o};
  float* split[3] = {static_cast<float*>(wh_s), static_cast<float*>(wu_s), static_cast<float*>(wv_s)};
  return gcn_layer<float>(B, C, D, eps, vact, eact, dynamic, in, ar_ws, sp_ws, p_ws, msg_ws, count_ws, slots,
                          split, out, static_cast<cudaStream_t>(stream));
}

// v, out [B, C, D]; e1, e2 [B, C]; m1, m2 [B, D]; w [D, D] (torch [out, in]);
// bias, ln scale, ln bias [D]; all contiguous in the compute type; D is 128 or
// 768.  float32: w_ws takes W's split image [D / 16, 2, D, 16] (written
// here by a first launch); bf16 does not read it.
DRIN_EXPORT int drin_vertex_update(int dtype, int B, int C, int D, float eps, int vact, const void* v,
                                   const void* e1, const void* m1, const void* e2, const void* m2,
                                   const void* w, const void* bias, const void* lns, const void* lnb,
                                   void* w_ws, void* out, void* stream) {
  if (B < 1 || C < 1 || !built_width(D) || B > 65535 || (long long)B * C > 0x7fffffffLL / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B * C + kRT - 1) / kRT, 1);
  if (dtype == DT_BFLOAT16) {
    CUtensorMap m_v, m_w;
    int err = matrix_map<bf16>(&m_v, v, B * C, D);
    if (!err) err = matrix_map<bf16>(&m_w, w, D, D);
    if (err) return err;
    RowsArgs<bf16> a;
    memset(&a, 0, sizeof a);
    a.B = B, a.C = C, a.D = D, a.eps = eps, a.vact = vact;
    a.u[0] = static_cast<const bf16*>(m1), a.u[1] = static_cast<const bf16*>(m2);
    a.e[0][0] = static_cast<const bf16*>(e1), a.e[0][1] = static_cast<const bf16*>(e2);
    a.bias = static_cast<const bf16*>(bias), a.lns = static_cast<const bf16*>(lns);
    a.lnb = static_cast<const bf16*>(lnb), a.out[0] = static_cast<bf16*>(out);
    return launch_norm<bf16, M_VERTEX>(D, grid, m_v, m_v, m_w, a, s);
  }
  if (dtype != DT_FLOAT32) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m_v;
  int err = matrix_map<float>(&m_v, v, B * C, D);
  if (err) return err;
  SplitArgs sa;
  memset(&sa, 0, sizeof sa);
  sa.w[0] = static_cast<const float*>(w), sa.img[0] = static_cast<float*>(w_ws);
  err = split_weights(sa, 1, D, s);
  if (err) return err;
  RowsArgs<float> a;
  memset(&a, 0, sizeof a);
  a.B = B, a.C = C, a.D = D, a.eps = eps, a.vact = vact;
  a.u[0] = static_cast<const float*>(m1), a.u[1] = static_cast<const float*>(m2);
  a.e[0][0] = static_cast<const float*>(e1), a.e[0][1] = static_cast<const float*>(e2);
  a.bias = static_cast<const float*>(bias), a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb), a.out[0] = static_cast<float*>(out);
  a.w = static_cast<const float*>(w_ws);
  return launch_norm<float, M_VERTEX>(D, grid, m_v, m_v, m_v, a, s);
}

// dynamic shared memory of the row kernel at `cols` output columns per block
// (768 for the LayerNorm launches at D=768, 128 for the fold) and the blocks
// of launch B's form that share an SM (for the sweep tool and the records);
// negative for a width that is not built
DRIN_EXPORT int drin_gcn_rows_smem(int cols) {
  if (cols == 2 * 384) return Ring<bf16, 384>::kSmem;
  if (cols == 2 * 64) return Ring<bf16, 64>::kSmem;
  if (cols == 2 * kProjNW) return Ring<bf16, kProjNW>::kSmem;
  return -1;
}
DRIN_EXPORT int drin_gcn_rows_blocks_per_sm(int cols) {
  if (cols == 2 * 384) return blocks_per_sm(gcn_rows_bf16<M_ENTITY, 384, true>, kBThreads, Ring<bf16, 384>::kSmem);
  if (cols == 2 * 64) return blocks_per_sm(gcn_rows_bf16<M_ENTITY, 64, true>, kBThreads, Ring<bf16, 64>::kSmem);
  return -1;
}
DRIN_EXPORT int drin_gcn_rows_f32_smem(int cols) {
  if (cols == 2 * 384) return Ring<float, 384>::kSmem;
  if (cols == 2 * 64) return Ring<float, 64>::kSmem;
  if (cols == 2 * kProjNW) return Ring<float, kProjNW>::kSmem;
  return -1;
}
DRIN_EXPORT int drin_gcn_rows_f32_blocks_per_sm(int cols) {
  if (cols == 2 * 384) return blocks_per_sm(gcn_rows_f32<M_ENTITY, 384, true>, kBThreads, Ring<float, 384>::kSmem);
  if (cols == 2 * 64) return blocks_per_sm(gcn_rows_f32<M_ENTITY, 64, true>, kBThreads, Ring<float, 64>::kSmem);
  return -1;
}
