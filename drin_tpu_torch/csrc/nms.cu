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
// removed and ORs its row of a suppression bitmask into the removed set:
// every earlier box has been kept or removed by the time the walk reaches
// it, so a row needs only the boxes after it.  box_iou is symmetric bit for
// bit, so row i of the mask is the JAX loop's iou[best].
//
// Arithmetic: IoU in drin_tpu's box_iou order with every operation rounded
// on its own (__fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn: no FMA
// contraction), so a pair at the threshold falls as it does in the plain
// version on the same inputs.
//
// Bound: bytes, a few MB a launch (boxes and scores read once, indices
// written once); the pairwise IoUs are ~20 FLOP each.  Design (the wrapper
// sorts first, torch.sort stable):
//   1. nms_mask_kernel: one block of 64 threads per (problem, 64 rows, 64
//      columns) tile on or above the diagonal; the tile's column boxes in
//      shared memory, each thread one 64-bit word: bit j of row i set when
//      sorted position j > i and IoU(i, j) > threshold.  Tiles below the
//      diagonal are never written and never read.
//   2. nms_walk_kernel: one warp per problem walks the sorted order 64
//      positions at a time.  Per chunk, one round trip brings the chunk's
//      diagonal words and scores (the first score not above -inf ends the
//      walk, NaN included, as the JAX loop's validity test does); the picks
//      inside the chunk are a bit walk in registers; the kept rows' words of
//      later chunks are ORed into the removed set in shared memory, and the
//      kept indices written out, in parallel over the lanes.

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 64;  // boxes per mask word; threads of the mask kernel

__device__ __forceinline__ float area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// box_iou(a, b) for one pair, in drin_tpu's operation order
__device__ __forceinline__ float iou(const float4 a, float area_a, const float4 b, float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ order, int n,
                int words, float thr, unsigned long long* __restrict__ mask) {
  const int row_tile = blockIdx.y, col_tile = blockIdx.x;
  if (col_tile < row_tile) return;
  const int64_t p = blockIdx.z;
  const float4* pb = boxes + p * n;
  const int64_t* po = order + p * n;
  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int col0 = col_tile * kTile;
  const int n_cols = min(n - col0, kTile);
  if (static_cast<int>(threadIdx.x) < n_cols) {
    const float4 b = pb[po[col0 + threadIdx.x]];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area(b);
  }
  __syncthreads();
  const int i = row_tile * kTile + threadIdx.x;
  if (i >= n) return;
  const float4 a = pb[po[i]];
  const float area_a = area(a);
  unsigned long long bits = 0;
  for (int j = col_tile == row_tile ? threadIdx.x + 1 : 0; j < n_cols; ++j)
    if (iou(a, area_a, cols[j], col_area[j]) > thr) bits |= 1ull << j;
  mask[(p * n + i) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(const float* __restrict__ sorted_scores, const int64_t* __restrict__ order,
                const unsigned long long* __restrict__ mask, int n, int words, int top_k,
                int64_t* __restrict__ out) {
  extern __shared__ unsigned long long removed[];  // [words]
  __shared__ unsigned long long diag[kTile];
  __shared__ int kept_pos[kTile];
  const int64_t p = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ps = sorted_scores + p * n;
  const int64_t* po = order + p * n;
  const unsigned long long* pm = mask + p * n * static_cast<int64_t>(words);
  int64_t* pout = out + p * top_k;
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  int kept = 0;
  bool more = true;
  for (int c = 0; c < words && more && kept < top_k; ++c) {
    // the chunk's diagonal words and its scores, in one round trip
    const int i0 = c * kTile + lane, i1 = i0 + 32;
    float s0 = -INFINITY, s1 = -INFINITY;
    if (i0 < n) {
      diag[lane] = pm[static_cast<int64_t>(i0) * words + c];
      s0 = ps[i0];
    }
    if (i1 < n) {
      diag[lane + 32] = pm[static_cast<int64_t>(i1) * words + c];
      s1 = ps[i1];
    }
    const unsigned lo = __ballot_sync(0xffffffffu, !(s0 > -INFINITY));
    const unsigned hi = __ballot_sync(0xffffffffu, !(s1 > -INFINITY));
    const unsigned long long stop = (static_cast<unsigned long long>(hi) << 32) | lo;
    unsigned long long live = stop ? (1ull << (__ffsll(static_cast<long long>(stop)) - 1)) - 1 : ~0ull;
    more = stop == 0ull;
    __syncwarp();
    // every lane walks the chunk alike: the same picks in registers
    unsigned long long todo = live & ~removed[c];
    int n_kept = 0;
    while (todo && kept + n_kept < top_k) {
      const int r = __ffsll(static_cast<long long>(todo)) - 1;
      if (lane == 0) kept_pos[n_kept] = c * kTile + r;
      ++n_kept;
      todo &= todo - 1;
      todo &= ~diag[r];
    }
    __syncwarp();
    // the kept rows' words of later chunks into the removed set
    for (int k = c + 1 + lane; k < words; k += 32) {
      unsigned long long acc = 0ull;
      for (int t = 0; t < n_kept; ++t) acc |= pm[static_cast<int64_t>(kept_pos[t]) * words + k];
      removed[k] |= acc;
    }
    for (int t = lane; t < n_kept; t += 32) pout[kept + t] = po[kept_pos[t]];
    kept += n_kept;
    __syncwarp();
  }
  for (int t = kept + lane; t < top_k; t += 32) pout[t] = -1;
}

}  // namespace

// boxes f32 [P, n, 4] (16-byte aligned), sorted_scores f32 [P, n] (each row
// in descending order), order int64 [P, n] (the sort's indices), mask
// scratch [P, n, ceil(n / 64)] 64-bit words, out int64 [P, top_k].
DRIN_EXPORT int drin_nms(const void* boxes, const void* sorted_scores, const void* order,
                         void* mask, void* out, int P, int n, int top_k, float thr,
                         void* stream) {
  if (P <= 0 || n <= 0 || top_k <= 0 || P > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (n + kTile - 1) / kTile;
  if (words > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const int64_t* o = static_cast<const int64_t*>(order);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(words, words, P), kTile, 0, s>>>(b, o, n, words, thr, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_walk_kernel<<<P, 32, smem, s>>>(static_cast<const float*>(sorted_scores), o, m, n, words,
                                      top_k, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
