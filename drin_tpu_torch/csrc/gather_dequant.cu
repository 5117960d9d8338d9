// Fused entity-row gather + int8 dequantization for Hopper (sm_90a).
//
// Replaces drin_tpu/ops/pallas/gather.py::gather_dequant (body _kernel).
// The packed table keeps the JAX package's byte layout: row n is m sub-rows
// of 128 int8 lanes (text | image | obj chunks, then zero pad sub-rows), and
// scales[n, j] is the f32 scale of sub-row j.  Each chunk's output row is the
// chunk's sub-rows dequantized, (float(q) * scale) rounded once to the
// output type -- bit-equal to the plain version.
//
// Row indices arrive as the caller gave them, int32 or int64 (a template on
// the index type), and are checked here with the JAX package's semantics: a
// negative index wraps once, then every index clamps into [0, N), in int64
// (ops/cuda/gather.py sanitize_rows).  No load leaves the table.
//
// Bound: bytes.  At B=64, C=101 (R=6464 rows, 44 data sub-rows of 128 B at
// the WikiMEL widths) it reads ~36 MB of int8 and writes ~73 MB of bf16; no
// arithmetic is worth counting.  Design: a persistent grid, kBlocksPerSm
// blocks on each SM, each taking a contiguous range of the rows.  A block's
// first warp is its producer: it loads 32 indices at a time, checks them, and
// one elected lane issues for each row two bulk copies (cp.async.bulk) into a
// ring of stages in shared memory -- the row's data sub-rows (never the pad)
// and its m scales -- that complete on the stage's mbarrier by their byte
// count.  The other warps dequantize a landed stage from shared memory with
// 16-byte reads.  Rows of kBulkMinBytes of output or more go into an output
// area of the stage, which one thread writes back with a bulk shared->global
// copy a chunk, the stage going back to the producer once that copy has read
// it; smaller rows are written with 16-byte vector stores and the stage goes
// back at once (the bulk copy's wait per row costs more than it saves there).  Up to kMaxStages rows are in flight per block while
// earlier ones are dequantized and stored.  The chunks' outputs are one
// buffer: chunk k's [R, w_k] block starts R * 128 * lo_k elements in.

#include "hopper.cuh"

namespace {

constexpr int kLanes = 128;  // int8 lanes per sub-row
constexpr int kMaxChunks = 4;
constexpr int kMaxStages = 16;
#ifndef DRIN_GATHER_BULK_MIN_BYTES
#define DRIN_GATHER_BULK_MIN_BYTES 4096
#endif
// output bytes of a row from which bulk stores write it back (below, vector
// stores): on the H100 bulk stores read faster at DRIN's 11 KB bf16 rows and
// the 7 KB of text + image, vector stores at the text-only slab's 3 KB
constexpr int kBulkMinBytes = DRIN_GATHER_BULK_MIN_BYTES;
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = 32 + kConsumers;  // the producer warp, then the consumers
constexpr int kBlocksPerSm = 3;
constexpr int kBlockSmem = 72 * 1024;  // dynamic shared memory a block: 3 share an SM

struct Chunks {
  int n;
  int lo[kMaxChunks];  // sub-row span [lo, hi) of each chunk; lo[0] = 0, lo[k+1] = hi[k]
  int hi[kMaxChunks];
};

// (a, b) -> two round-to-nearest-even bf16 in one 32-bit word, a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16) | __bfloat16_as_ushort(h.x);
}

// 16 dequantized values out of registers: 16-byte vector stores only (to
// global or shared memory)
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

// contiguous bytes from shared to global memory, tracked by this thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}

// stage layout: int8 data sub-rows, then the row's m scales, then (bulk
// stores only) the dequantized data sub-rows in the output type
template <typename T, bool kBulkStore>
__host__ __device__ __forceinline__ int stage_bytes(int n_data, int m) {
  return n_data * kLanes + m * 4 + (kBulkStore ? n_data * kLanes * static_cast<int>(sizeof(T)) : 0);
}

template <typename T, typename Idx, bool kBulkStore>
__global__ void __launch_bounds__(kThreads)
gather_dequant_kernel(const int8_t* __restrict__ table, const float* __restrict__ scales,
                      const Idx* __restrict__ rows, int64_t N, int R, int m, Chunks ch,
                      int stages, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int tid = threadIdx.x, lane = tid % 32;
  // chunks are contiguous from sub-row 0; every index into ch below is a
  // compile-time constant, so the parameter struct never spills to the stack
  int n_data = ch.hi[0];
#pragma unroll
  for (int j = 1; j < kMaxChunks; ++j)
    if (j < ch.n) n_data = ch.hi[j];
  const int data_bytes = n_data * kLanes;
  const int sbytes = stage_bytes<T, kBulkStore>(n_data, m);
  const int per_block = (R + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * per_block, r1 = min(R, r0 + per_block);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kBulkStore ? 1 : kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 32) {  // the producer warp
    for (int base = r0; base < r1; base += 32) {
      int64_t v = base + lane < r1 ? static_cast<int64_t>(rows[base + lane]) : 0;
      v = v < 0 ? v + N : v;  // wrap once, then clamp
      v = v < 0 ? 0 : (v >= N ? N - 1 : v);
      for (int t = 0; t < 32 && base + t < r1; ++t) {
        const int64_t row = __shfl_sync(0xffffffffu, v, t);
        const int i = base + t - r0, s = i % stages;
        mbar_wait(smem_u32(&empty[s]), ((i / stages) & 1) ^ 1);  // a fresh barrier passes
        if (lane == 0) {
          const uint32_t dst = smem_u32(smem + static_cast<size_t>(s) * sbytes);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, data_bytes + m * 4);
          bulk_load(dst, table + row * m * kLanes, data_bytes, bar);
          bulk_load(dst + data_bytes, scales + row * m, m * 4, bar);
        }
      }
    }
    return;
  }

  const int ct = tid - 32;  // consumer thread
  // rows whose bulk stores may still be reading their stages (bulk stores
  // only): each keeps its stage from the producer, so at most stages - 1
  const int lag = min(3, stages - 1);
  for (int r = r0; r < r1; ++r) {
    const int i = r - r0, s = i % stages;
    unsigned char* stage = smem + static_cast<size_t>(s) * sbytes;
    mbar_wait(smem_u32(&full[s]), (i / stages) & 1);
    const float* sc = reinterpret_cast<const float*>(stage + data_bytes);
    T* staged_out = reinterpret_cast<T*>(stage + data_bytes + m * 4);
    for (int v = ct; v < n_data * (kLanes / 16); v += kConsumers) {
      const int sr = v / (kLanes / 16);          // sub-row
      const int off = (v % (kLanes / 16)) * 16;  // byte within the sub-row
      int lo = ch.lo[0], hi = ch.hi[0];
#pragma unroll
      for (int j = 1; j < kMaxChunks; ++j)
        if (j < ch.n && sr >= ch.lo[j]) {
          lo = ch.lo[j];
          hi = ch.hi[j];
        }
      const float f = sc[sr];
      const uint4 raw = *reinterpret_cast<const uint4*>(stage + sr * kLanes + off);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      float vals[16];
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) vals[4 * w + j] = int8_at(words[w], j) * f;
      if (kBulkStore) {
        store16<T>(staged_out + sr * kLanes + off, vals);
      } else {
        const int64_t width = static_cast<int64_t>(hi - lo) * kLanes;
        T* dst = out + static_cast<int64_t>(R) * kLanes * lo + r * width + (sr - lo) * kLanes + off;
        store16<T>(dst, vals);
      }
    }
    if (!kBulkStore) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      continue;
    }
    // bulk stores: the stage's output area written back a chunk a copy by one
    // thread, whose read of it must end before the stage is filled again
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (ct == 0) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
        if (j < ch.n) {
          const int64_t width = static_cast<int64_t>(ch.hi[j] - ch.lo[j]) * kLanes;
          bulk_store(out + static_cast<int64_t>(R) * kLanes * ch.lo[j] + r * width,
                     smem_u32(staged_out + ch.lo[j] * kLanes),
                     static_cast<uint32_t>(width * sizeof(T)));
        }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // up to `lag` rows' stores still reading; the row before them is read
      // out and its stage goes back to the producer
      if (lag >= 3)
        asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory");
      else if (lag == 2)
        asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
      else
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (i >= lag) mbar_arrive(smem_u32(&empty[(i - lag) % stages]));
    }
  }
  if (kBulkStore && ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;

// the current device's SM count (132 on an H100 SXM), read once a device
int sm_count(int dev) {
  static int n[kMaxDevices] = {0};
  if (n[dev] == 0 && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n[dev];
}

template <typename T, typename Idx, bool kBulkStore>
cudaError_t launch_stores(const int8_t* t, const float* sc, const void* rows, int64_t N, int R, int m,
                   const Chunks& ch, void* out, cudaStream_t s) {
  const int n_data = ch.hi[ch.n - 1];
  const int sbytes = stage_bytes<T, kBulkStore>(n_data, m);
  const int stages = min(kMaxStages, kBlockSmem / sbytes);
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = stages * sbytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || sm_count(dev) == 0) return cudaErrorInvalidDevice;
  static bool opted[kMaxDevices] = {false};  // one attribute call per instantiation and device
  if (!opted[dev]) {
    e = allow_smem(gather_dequant_kernel<T, Idx, kBulkStore>, kBlockSmem);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  const int grid = min(R, kBlocksPerSm * sm_count(dev));
  gather_dequant_kernel<T, Idx, kBulkStore><<<grid, kThreads, smem, s>>>(
      t, sc, static_cast<const Idx*>(rows), N, R, m, ch, stages, static_cast<T*>(out));
  return cudaGetLastError();
}

// bulk or vector stores by the bytes of an output row
template <typename T, typename Idx>
cudaError_t launch(const int8_t* t, const float* sc, const void* rows, int64_t N, int R, int m,
                   const Chunks& ch, void* out, cudaStream_t s) {
  const int64_t row_bytes = static_cast<int64_t>(ch.hi[ch.n - 1]) * kLanes * sizeof(T);
  return row_bytes >= kBulkMinBytes ? launch_stores<T, Idx, true>(t, sc, rows, N, R, m, ch, out, s)
                                    : launch_stores<T, Idx, false>(t, sc, rows, N, R, m, ch, out, s);
}

}  // namespace

// table int8 [N, m*128]; scales f32 [N, m]; rows [R] int32 (idx64 = 0) or
// int64 (idx64 = 1), any values; out one buffer of R * hi_last * 128 values of
// dtype, chunk k's [R, (hi_k - lo_k) * 128] at R * 128 * lo_k; unused chunks
// pass n_chunks < 4.  table, scales and out 16-byte aligned.
DRIN_EXPORT int drin_gather_dequant(const void* table, const void* scales, const void* rows,
                                    int idx64, long long N, int R, int dtype, int m, int n_chunks,
                                    int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,
                                    int lo3, int hi3, void* out, void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxChunks || N < 1 || m % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Chunks ch;
  ch.n = n_chunks;
  const int lo[4] = {lo0, lo1, lo2, lo3}, hi[4] = {hi0, hi1, hi2, hi3};
  for (int i = 0; i < kMaxChunks; ++i) {
    ch.lo[i] = lo[i];
    ch.hi[i] = hi[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* t = static_cast<const int8_t*>(table);
  const float* sc = static_cast<const float*>(scales);
  cudaError_t e;
  if (dtype == DT_BFLOAT16)
    e = idx64 ? launch<__nv_bfloat16, int64_t>(t, sc, rows, N, R, m, ch, out, s)
              : launch<__nv_bfloat16, int32_t>(t, sc, rows, N, R, m, ch, out, s);
  else if (dtype == DT_FLOAT32)
    e = idx64 ? launch<float, int64_t>(t, sc, rows, N, R, m, ch, out, s)
              : launch<float, int32_t>(t, sc, rows, N, R, m, ch, out, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}
