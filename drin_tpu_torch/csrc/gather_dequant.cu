// Fused entity-row gather + int8 dequantization for Hopper (sm_90a).
//
// Replaces drin_tpu/ops/pallas/gather.py::gather_dequant (body _kernel).
// The packed table keeps the JAX package's byte layout: row n is m sub-rows
// of 128 int8 lanes (text | image | obj chunks, then zero pad sub-rows), and
// scales[n, j] is the f32 scale of sub-row j.  Each chunk's output row is the
// chunk's sub-rows dequantized, (float(q) * scale) rounded once to the
// output type -- bit-equal to the plain version.
//
// Bound: bytes.  At B=64, C=101 (R=6464 rows, 44 data sub-rows of 128 B at
// the WikiMEL widths) it reads ~36 MB of int8 and writes ~73 MB of bf16; no
// arithmetic is worth counting.  Design: one warp per requested row, each
// lane moving 16 bytes of int8 per step (eight lanes cover one sub-row, a
// warp four), so every global load is a 16-byte vector and a warp's loads
// are one contiguous 512-byte run.  Only the data sub-rows are read (the
// slab's pad sub-rows are skipped), and only the dequantized output is
// written: nothing intermediate touches device memory.  Row indices arrive
// already wrapped and clamped by the wrapper, so no load leaves the table.

#include "common.cuh"

namespace {

constexpr int kLanes = 128;         // int8 lanes per sub-row
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChunks = 4;

struct Chunks {
  int n;
  int lo[kMaxChunks];  // sub-row span [lo, hi) of each chunk
  int hi[kMaxChunks];
  void* out[kMaxChunks];
};

// (a, b) -> two round-to-nearest-even bf16 in one 32-bit word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16) | __bfloat16_as_ushort(h.x);
}

// 16 dequantized values out of registers: 16-byte vector stores only
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float (&v)[16]);

template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* dst, const float (&v)[16]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  d[1] = make_uint4(pack_bf16x2(v[8], v[9]), pack_bf16x2(v[10], v[11]),
                    pack_bf16x2(v[12], v[13]), pack_bf16x2(v[14], v[15]));
}

template <>
__device__ __forceinline__ void store16<float>(float* dst, const float (&v)[16]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// byte j of w as a signed int8 (little-endian: byte 0 is the lowest address)
__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
gather_dequant_kernel(const int8_t* __restrict__ table, const float* __restrict__ scales,
                      const int32_t* __restrict__ rows, int R, int m, Chunks ch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarpsPerBlock + warp;
  if (r >= R) return;
  const int64_t row = rows[r];
  const int8_t* src = table + row * (int64_t)m * kLanes;
  const float* sc = scales + row * (int64_t)m;
  // chunks are contiguous from sub-row 0; every index into ch below is a
  // compile-time constant, so the parameter struct never spills to the stack
  int n_data = ch.hi[0];
#pragma unroll
  for (int j = 1; j < kMaxChunks; ++j)
    if (j < ch.n) n_data = ch.hi[j];
  const int n_vec = n_data * (kLanes / 16);
  for (int v = lane; v < n_vec; v += 32) {
    const int sr = v / (kLanes / 16);     // sub-row
    const int off = (v % (kLanes / 16)) * 16;  // byte within the sub-row
    int lo = ch.lo[0], hi = ch.hi[0];
    void* out = ch.out[0];
#pragma unroll
    for (int j = 1; j < kMaxChunks; ++j)
      if (j < ch.n && sr >= ch.lo[j]) {
        lo = ch.lo[j];
        hi = ch.hi[j];
        out = ch.out[j];
      }
    const float s = sc[sr];
    const uint4 raw = *reinterpret_cast<const uint4*>(src + sr * kLanes + off);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    float vals[16];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int j = 0; j < 4; ++j) vals[4 * w + j] = int8_at(words[w], j) * s;
    const int64_t width = (int64_t)(hi - lo) * kLanes;
    T* dst = static_cast<T*>(out) + r * width + (sr - lo) * kLanes + off;
    store16<T>(dst, vals);
  }
}

}  // namespace

// table int8 [N, m*128]; scales f32 [N, m]; rows int32 [R] in [0, N);
// out_k [R, (hi_k - lo_k) * 128] of dtype; unused chunks pass n_chunks < 4.
DRIN_EXPORT int drin_gather_dequant(const void* table, const void* scales, const void* rows,
                                    int R, int m, int dtype, int n_chunks,
                                    int lo0, int hi0, void* out0, int lo1, int hi1, void* out1,
                                    int lo2, int hi2, void* out2, int lo3, int hi3, void* out3,
                                    void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Chunks ch;
  ch.n = n_chunks;
  const int lo[4] = {lo0, lo1, lo2, lo3}, hi[4] = {hi0, hi1, hi2, hi3};
  void* out[4] = {out0, out1, out2, out3};
  for (int i = 0; i < kMaxChunks; ++i) {
    ch.lo[i] = lo[i];
    ch.hi[i] = hi[i];
    ch.out[i] = out[i];
  }
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock), block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* t = static_cast<const int8_t*>(table);
  const float* sc = static_cast<const float*>(scales);
  const int32_t* rw = static_cast<const int32_t*>(rows);
  if (dtype == DT_BFLOAT16)
    gather_dequant_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(t, sc, rw, R, m, ch);
  else if (dtype == DT_FLOAT32)
    gather_dequant_kernel<float><<<grid, block, 0, s>>>(t, sc, rw, R, m, ch);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
