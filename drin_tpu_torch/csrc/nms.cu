// Greedy non-maximum suppression for Hopper (sm_90a), many problems a launch.
//
// The counterpart of drin_tpu/ops/detection.py::nms, a jnp function (a
// lax.fori_loop over the picks inside one compiled program), not of a Pallas
// kernel.  Eager PyTorch has no such program: a per-pick loop from Python
// would launch ~20,000 kernels per detector image (4 x 1000 + 507 RPN picks,
// up to 100 class picks), so the loop is this kernel.
//
// Semantics (the JAX loop's, index for index): top_k times, pick the live box
// of the highest score, the lowest index among equal scores; once that score
// is -inf the remaining slots are -1; remove the pick and every box whose IoU
// with it is strictly above the threshold.  With the scores sorted in
// descending order by a stable sort (ties: lower index first, as jnp.argmax
// picks), that is a walk down the sorted order that keeps each box not yet
// removed and removes the later boxes it overlaps: every earlier box has been
// kept or removed by the time the walk reaches a box, so a kept box needs
// only the boxes after it.  The walk ends at the first sorted score that is
// not above -inf (NaN included, as the JAX loop's validity test) or at top_k.
//
// Arithmetic: IoU in drin_tpu's box_iou order with every operation rounded
// on its own (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn: no FMA
// contraction), the kept box as operand a, so a pair at the threshold falls
// as it does in the plain version on the same inputs.
//
// Bound: the bytes of boxes, scores and indices, or ~14 FLOP for each IoU of
// a kept box against a later box still live at its pick.  Design: one
// launch for all problems, one cluster of 1-4 blocks a problem (the most
// that leave one block an SM: a detector forward's 40 RPN problems take 2,
// its 8 class problems 4), nothing written to device memory but the kept
// indices (in place of a [n, n / 64] bitmask in device memory, which held
// every IoU above the diagonal).  Each block finds the end of the walk (the
// first score not above -inf: padded boxes cost nothing after it) and stages
// the live boxes and their areas in sorted order in shared memory.  The
// removed set is a bitmask in shared memory, one 32-bit word per 32 sorted
// positions.  Then per chunk of 64 sorted positions:
//   (a) the chunk's upper triangle of IoU bits, its 2,016 pairs spread evenly
//       over the threads, computed under the previous chunk's column pass
//       (so every pair of it: its rows' fate is not known yet);
//   (b) one warp walks the chunk in registers: 64 fixed steps, each a bit
//       test and an OR of a diagonal word loaded ahead, with no branch; the
//       kept positions are the bits left clear, cut at top_k;
//   (c) all threads test every later column that is still live against the
//       chunk's kept rows only, a warp owning one 32-bit removed word, so one
//       __ballot_sync gives its new bits with no atomics (where the words are
//       fewer than the warps, warps split a word's kept rows and OR their
//       bits in); a word already all removed is skipped.
// The kept sorted positions go out as they are picked and become indices
// once, at the end.  In a cluster every block stages the boxes and runs (a)
// and (b) alike; removed word w belongs to block w % cluster size, which
// alone runs (c) for it, and a chunk's two words are read from their owners
// through distributed shared memory after a cluster barrier.  A thread
// tests kUnroll pairs at a time with no branch: an approximate quotient
// decides each pair outside a narrow band around the threshold, the rounded
// division inside it.
// Problems too large to stage (more than kMaxStaged boxes) read their column
// boxes through `order` from global memory (L2) instead.

#include <cmath>

#include "common.cuh"

namespace {

#ifndef DRIN_NMS_CLUSTER_MAX
#define DRIN_NMS_CLUSTER_MAX 4  // 1 turns clusters off (tools/nms_gather_sweep.py)
#endif
#ifndef DRIN_NMS_PROFILE
#define DRIN_NMS_PROFILE 0  // 1: cycles by phase (tools/nms_gather_sweep.py --nms-phases)
#endif
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                      // sorted positions a walk step
constexpr int kPairs = kChunk * (kChunk - 1) / 2;              // a chunk's upper triangle
constexpr int kTriPairs = (kPairs + kThreads - 1) / kThreads;  // of it a thread
static_assert(kTriPairs <= 32, "a thread's triangle pairs fit one mask");
constexpr int kMinBlocks = 2;  // blocks an SM the registers leave room for (of 512 threads)
constexpr int kClusterMax = DRIN_NMS_CLUSTER_MAX;  // blocks a problem, at most (1, 2, 4 or 8)
static_assert(kClusterMax == 1 || kClusterMax == 2 || kClusterMax == 4 || kClusterMax == 8, "cluster");
constexpr int kUnroll = 4;  // kept rows tested together against one column
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory a block may take
// staged: a box (16 B) and its area (4 B) a position, and the removed words
constexpr int kMaxStaged = (kSmemBudget - 1024) / 20;

__device__ __forceinline__ float area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// box_iou's intersection of a and b, in drin_tpu's operation order
__device__ __forceinline__ float intersection(const float4 a, const float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  return __fmul_rn(w, h);
}

// The threshold, and a band around it outside which an approximate quotient
// decides `inter / union > thr` exactly: __fdividef is within 2 ulp (2^-22
// relative) of the quotient for a divisor in [2^-126, 2^126], so a value
// above hi (below lo) is from a quotient that rounds above thr (to at most
// thr).  Only a threshold in [2^-20, 2^100] takes the band (the union is
// at least 1e-9, so a quotient of a subnormal intersection lies below it).
struct Threshold {
  float thr, lo, hi;
  bool band;
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  const bool band = thr >= 0x1p-20f && thr <= 0x1p100f;
  return {thr, thr * (1.f - 0x1p-18f), thr * (1.f + 0x1p-18f), band};
}

// Which of the K pairs (a[u], b[u]) marked in `valid` have box_iou(a, b) >
// thr, as drin_tpu computes it (a bit a pair)?  Every pair's intersection,
// union and approximate quotient first, with no branch, so that the pairs'
// chains overlap; the rounded division (__fdiv_rn) only for a pair whose
// quotient lies in the band around thr, or that `covered` leaves out: a
// pair is covered when the band is on and both areas are finite and at most
// 2^125 (then the intersection is at most the smaller area, and the union
// lies in [1e-9, 2^126], where __fdividef keeps its 2 ulp).
__device__ __forceinline__ bool in_band_range(float area_) { return area_ <= 0x1p125f; }

template <int K>
__device__ __forceinline__ unsigned removes(const float4 (&a)[K], const float (&area_a)[K],
                                            const float4 (&b)[K], const float (&area_b)[K],
                                            unsigned valid, unsigned covered, const Threshold& t) {
  float inter[K], uni[K];
  unsigned hit = 0u, open = 0u;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    inter[u] = intersection(a[u], b[u]);
    uni[u] = fmaxf(__fsub_rn(__fadd_rn(area_a[u], area_b[u]), inter[u]), 1e-9f);
    const float q = __fdividef(inter[u], uni[u]);
    const bool cov = t.band && ((covered >> u) & 1u);
    if (cov && q > t.hi) hit |= 1u << u;
    if (!(cov && (q > t.hi || q < t.lo))) open |= 1u << u;
  }
  open &= valid;
  if (open) {
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (((open >> u) & 1u) && __fdiv_rn(inter[u], uni[u]) > t.thr) hit |= 1u << u;
  }
  return hit & valid;
}

// (a) for one chunk of len sorted positions (rows cb, areas ca): its upper
// triangle's kPairs pairs spread evenly over the threads (kTriPairs a
// thread, from the pair table), a hit ORed into its row's word of diag
__device__ __forceinline__ void triangle(const float4* cb, const float* ca, int len,
                                         const uint16_t* pair_ij, unsigned long long* diag, int tid,
                                         const Threshold& th) {
  float4 a[kTriPairs], b[kTriPairs];
  float aa[kTriPairs], ab[kTriPairs];
  int row[kTriPairs], col[kTriPairs];
  unsigned valid = 0u, covered = 0u;
#pragma unroll
  for (int k = 0; k < kTriPairs; ++k) {
    const int idx = tid + k * kThreads;
    const uint32_t ij = idx < kPairs ? pair_ij[idx] : 0u;
    const bool on = idx < kPairs && static_cast<int>(ij >> 8) < len;
    row[k] = on ? ij & 0xff : 0;
    col[k] = on ? ij >> 8 : 0;
    a[k] = cb[row[k]];
    aa[k] = ca[row[k]];
    b[k] = cb[col[k]];
    ab[k] = ca[col[k]];
    if (on) valid |= 1u << k;
    if (in_band_range(aa[k]) && in_band_range(ab[k])) covered |= 1u << k;
  }
  const unsigned hit = removes<kTriPairs>(a, aa, b, ab, valid, covered, th);
#pragma unroll
  for (int k = 0; k < kTriPairs; ++k)
    if ((hit >> k) & 1u) atomicOr(&diag[row[k]], 1ull << col[k]);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster: writes before it (shared
// memory included) are seen by reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the word at `local`'s offset in block `rank`'s shared memory
__device__ __forceinline__ uint32_t load_shared_of(const uint32_t* local, uint32_t rank) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

#if DRIN_NMS_PROFILE
// Cycles between the block-wide barriers as thread 0 of a problem's first
// block sees them, summed over chunks, for the first kProfiled problems
// (read by tools/nms_gather_sweep.py --nms-phases): 0 staging and the first
// chunk's triangle, 1 the chunk's first barrier (the other warps' and
// blocks' column passes end there), 2 the walk, 3 warp 0's column pass, its
// share of the next chunk's triangle and the kept positions out.
constexpr int kProfiled = 64, kPhases = 4;
__device__ unsigned long long nms_phase_cycles[kProfiled][kPhases];
#define NMS_PHASE(k)                                                      \
  if (tid == 0 && rank == 0 && p < kProfiled) {                           \
    const long long now_ = clock64();                                     \
    nms_phase_cycles[p][k] += static_cast<unsigned long long>(now_ - t_); \
    t_ = now_;                                                            \
  }
#else
#define NMS_PHASE(k)
#endif

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ sorted_scores,
           const int64_t* __restrict__ order, int n, int top_k, float thr,
           int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // bit j of row i: i < j, i removes j; two buffers, the walk reading one
  // while the next chunk's triangle is ORed into the other
  __shared__ __align__(16) unsigned long long diag[2][kChunk];
  __shared__ uint16_t pair_ij[kPairs];  // the upper triangle's pairs: i | j << 8
  __shared__ float4 chunk_box[2][kChunk];  // this and the next chunk's rows (unstaged problems)
  __shared__ float chunk_area[2][kChunk];
  __shared__ float4 kept_box[kChunk + kUnroll];  // the chunk's kept rows, compacted
  __shared__ float kept_area[kChunk + kUnroll];
  __shared__ int kept_pos[kChunk];
  __shared__ int n_live_s, n_kept_s, kept_in_range_s;
  const int C = static_cast<int>(cluster_size()), rank = static_cast<int>(cluster_rank());
  const Threshold th = make_threshold(thr);
  const int64_t p = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float4* pb = boxes + p * n;
  const float* ps = sorted_scores + p * n;
  const int64_t* po = order + p * n;
  int64_t* pout = out + p * top_k;
  const int words = (n + 31) / 32;  // removed words of 32 positions; word w is block w % C's
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + (kStaged ? 16 * static_cast<size_t>(n) : 0));
  uint32_t* removed = reinterpret_cast<uint32_t*>(
      smem + (kStaged ? 20 * static_cast<size_t>(n) : 0));
  // chunk rows: staged, or loaded into buffer (chunk & 1) by rows of threads
  auto load_chunk = [&](int c0_, int buf, int t) {
    if (!kStaged && t < kChunk && c0_ + t < n) {
      const float4 b = pb[po[c0_ + t]];
      chunk_box[buf][t] = b;
      chunk_area[buf][t] = area(b);
    }
  };

#if DRIN_NMS_PROFILE
  long long t_ = clock64();
#endif
  if (tid == 0) n_live_s = n;
  for (int w = tid; w < words; w += kThreads) removed[w] = 0u;
  if (tid < kChunk) {  // row i's pairs (i, i + 1 .. 63) from offset i * 63 - i * (i - 1) / 2
    diag[0][tid] = diag[1][tid] = 0ull;
    const int at = tid * (kChunk - 1) - tid * (tid - 1) / 2;
    for (int j = tid + 1; j < kChunk; ++j) pair_ij[at + j - tid - 1] = static_cast<uint16_t>(tid | j << 8);
  }
  load_chunk(0, 0, tid);
  __syncthreads();
  {  // the end of the walk: the first sorted score not above -inf
    int first = n;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads)
      if (!(ps[i] > -INFINITY)) first = min(first, i);
    first = __reduce_min_sync(0xffffffffu, first);
    if (lane == 0 && first < n) atomicMin(&n_live_s, first);
  }
  __syncthreads();
  const int n_live = n_live_s;
  if (kStaged) {  // the live boxes in sorted order
#pragma unroll 4
    for (int i = tid; i < n_live; i += kThreads) {
      const float4 b = pb[po[i]];
      sbox[i] = b;
      sarea[i] = area(b);
    }
    __syncthreads();
  }
  if (n_live > 0)
    triangle(kStaged ? sbox : chunk_box[0], kStaged ? sarea : chunk_area[0], min(kChunk, n_live),
             pair_ij, diag[0], tid, th);

  NMS_PHASE(0)
  int kept = 0;
  for (int c0 = 0, buf = 0; c0 < n_live && kept < top_k; c0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, n_live - c0);
    const float4* cb = kStaged ? sbox + c0 : chunk_box[buf];
    const float* ca = kStaged ? sarea + c0 : chunk_area[buf];
    // the chunk's removed words are final in their owners; its triangle is in
    if (C > 1)
      cluster_sync();
    else
      __syncthreads();
    NMS_PHASE(1)
    if (warp == 0) {
      // (b) one warp walks the chunk.  The chunk's two removed words first
      // (from their owners), then 64 fixed steps: a step keeps position r
      // unless an earlier pick or an earlier chunk removed it, and then
      // removes what its diagonal word holds; the word holds only later
      // positions, so bit r of the final set is its state at step r: the
      // kept positions are the bits left clear
      uint32_t mine = 0u;
      if (lane < 2) {
        const int w = c0 / 32 + lane;
        mine = w >= words ? 0u : w % C == rank ? removed[w] : load_shared_of(removed + w, w % C);
      }
      const unsigned long long gone =
          __shfl_sync(0xffffffffu, mine, 0) | static_cast<unsigned long long>(__shfl_sync(0xffffffffu, mine, 1)) << 32;
      unsigned long long rem = gone | (len == kChunk ? 0ull : ~0ull << len);
#pragma unroll
      for (int r0 = 0; r0 < kChunk; r0 += 8) {
        unsigned long long d[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = diag[buf][r0 + k];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (!(rem & (1ull << (r0 + k)))) rem |= d[k];
      }
      unsigned long long keep = ~rem;
      // top_k reached inside the chunk: the picks after it do not happen
      for (int extra = __popcll(keep) - (top_k - kept); extra > 0; --extra)
        keep &= ~(1ull << (63 - __clzll(keep)));
      // compact the kept rows: lane l places positions l and l + 32
      bool in_range = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        if ((keep >> r) & 1ull) {
          const int k = __popcll(keep & ((1ull << r) - 1));
          kept_pos[k] = c0 + r;
          kept_box[k] = cb[r];
          kept_area[k] = ca[r];
          in_range &= in_band_range(ca[r]);
        }
      }
      in_range = __all_sync(0xffffffffu, in_range);
      if (lane == 0) {
        n_kept_s = __popcll(keep);
        kept_in_range_s = in_range;
      }
      diag[buf ^ 1][lane] = 0ull;  // for the next chunk's triangle
      diag[buf ^ 1][lane + 32] = 0ull;
    } else if (warp <= 2) {
      load_chunk(c0 + kChunk, buf ^ 1, tid - 32);  // the next chunk's rows (unstaged problems)
    }
    __syncthreads();
    NMS_PHASE(2)
    const int n_kept = n_kept_s;
    const bool go_on = kept + n_kept < top_k;
    // (c) the kept rows against every later column still live, in this
    // block's words: a warp takes 32 columns (a word) and, where the words
    // are fewer than the warps, a slice of the kept rows
    const int g0 = (c0 + kChunk) / 32, g_end = (n_live + 31) / 32;
    const int first = g0 + ((rank - g0 % C) % C + C) % C;  // this block's first word
    const int n_groups = first < g_end ? (g_end - first + C - 1) / C : 0;
    if (n_kept > 0 && go_on && n_groups > 0) {
      const int slices = max(1, min(kWarps / n_groups, n_kept / (2 * kUnroll)));
      const int per = (n_kept + slices - 1) / slices;
      const bool kept_in_range = kept_in_range_s;
      for (int item = warp; item < n_groups * slices; item += kWarps) {
        const int w = first + (item / slices) * C, t0 = (item % slices) * per;
        const int t1 = min(n_kept, t0 + per);
        // a word another slice is writing may read stale: a removed column
        // tested once more costs IoUs, never a pick
        const uint32_t was = removed[w];
        if (was == 0xffffffffu) continue;
        const int j = w * 32 + lane;
        bool hit = false;
        if (j < n_live && !((was >> lane) & 1u)) {
          const float4 b = kStaged ? sbox[j] : pb[po[j]];
          const float ab = kStaged ? sarea[j] : area(b);
          const unsigned covered = kept_in_range && in_band_range(ab) ? ~0u : 0u;
          for (int t = t0; t < t1 && !hit; t += kUnroll) {
            float4 a[kUnroll], bs[kUnroll];
            float aa[kUnroll], abs_[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              a[u] = kept_box[t + u];  // past t1: read, never used
              aa[u] = kept_area[t + u];
              bs[u] = b;
              abs_[u] = ab;
            }
            const unsigned valid = (1u << min(kUnroll, t1 - t)) - 1u;
            hit = removes<kUnroll>(a, aa, bs, abs_, valid, covered, th) != 0u;
          }
        }
        const uint32_t bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && bits) {
          if (slices == 1)
            removed[w] = was | bits;  // this warp's word alone
          else
            atomicOr(&removed[w], bits);
        }
      }
    }
    // the next chunk's triangle, under the column pass (its rows not yet
    // known removed or live: every pair of it)
    if (go_on && c0 + kChunk < n_live)
      triangle(kStaged ? sbox + c0 + kChunk : chunk_box[buf ^ 1],
               kStaged ? sarea + c0 + kChunk : chunk_area[buf ^ 1], min(kChunk, n_live - c0 - kChunk),
               pair_ij, diag[buf ^ 1], tid, th);
    // the kept sorted positions; their indices are looked up once at the end
    if (rank == 0)
      for (int t = tid; t < n_kept; t += kThreads) pout[kept + t] = kept_pos[t];
    kept += n_kept;
    NMS_PHASE(3)
  }
  if (C > 1)
    cluster_sync();  // no block leaves while another may read its words
  else
    __syncthreads();
  if (rank == 0) {
    for (int t = tid; t < kept; t += kThreads) pout[t] = po[pout[t]];
    for (int t = kept + tid; t < top_k; t += kThreads) pout[t] = -1;
  }
}

constexpr int kMaxDevices = 64;

// the current device's SM count (132 on an H100 SXM), read once a device; 0 on an error
int sm_count() {
  static int n[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (n[dev] == 0 && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n[dev];
}

// Blocks a problem: the most (up to kClusterMax) that keep the launch within
// one block an SM, so that few problems spread over the card (two blocks on
// one SM share its issue slots, and the cluster runs at its slower block's
// pace: clusters of 4 for a forward's 40 RPN problems read slower than of 2)
int cluster_for(int P) {
  const int sms = sm_count();
  int c = 1;
  while (c < kClusterMax && static_cast<int64_t>(P) * (2 * c) <= sms) c *= 2;
  return c;
}

template <bool kStaged>
cudaError_t launch(const float4* b, const float* s, const int64_t* o, int P, int n, int top_k,
                   float thr, int64_t* out, cudaStream_t stream) {
  const size_t smem = (kStaged ? 20 * static_cast<size_t>(n) : 0) + 4 * static_cast<size_t>((n + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(nms_kernel<kStaged>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int c = cluster_for(P);
  if (c == 1) {
    nms_kernel<kStaged><<<P, kThreads, smem, stream>>>(b, s, o, n, top_k, thr, out);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(P) * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nms_kernel<kStaged>, b, s, o, n, top_k, thr, out);
}

}  // namespace

#if DRIN_NMS_PROFILE
// nms_phase_cycles into dst ([kProfiled, kPhases] uint64), then zeroes it
DRIN_EXPORT int drin_nms_phase_cycles(void* dst) {
  static const unsigned long long zero[kProfiled][kPhases] = {};
  cudaError_t e = cudaMemcpyFromSymbol(dst, nms_phase_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(nms_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

// boxes f32 [P, n, 4] (16-byte aligned), sorted_scores f32 [P, n] (each row
// in descending order), order int64 [P, n] (the sort's indices), out int64
// [P, top_k]; n at most kSmemBudget * 8 (a removed bit a box, in shared
// memory; ops/cuda/nms.py MAX_BOXES).  One launch; no scratch.
DRIN_EXPORT int drin_nms(const void* boxes, const void* sorted_scores, const void* order,
                         void* out, int P, int n, int top_k, float thr, void* stream) {
  if (P <= 0 || n <= 0 || top_k <= 0 || n > kSmemBudget * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* b = static_cast<const float4*>(boxes);
  const float* s = static_cast<const float*>(sorted_scores);
  const int64_t* o = static_cast<const int64_t*>(order);
  int64_t* dst = static_cast<int64_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(n <= kMaxStaged ? launch<true>(b, s, o, P, n, top_k, thr, dst, st)
                                          : launch<false>(b, s, o, P, n, top_k, thr, dst, st));
}
