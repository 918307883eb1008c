// Store writeback of the exact-tier decide, for Hopper (sm_90a).
//
//   data[bkt[i], :] += drow[i, :]   for i in [0, G), int32 two's-complement
//
// Replaces gubernator_tpu/core/pallas_sweep.py:_kernel (the Pallas store
// sweep) and computes the same function as the XLA scatter-add it stands
// in for (gubernator_tpu/core/kernels.py:_writeback_apply).
//
// Input contract (the decide's writeback plan guarantees it):
// - data is int32[buckets, W], row-major and contiguous, W = ways * 8 with
//   ways in {1, 2, 4, 8, 16}, so a row is 32..512 bytes, a whole number
//   of 16-byte vectors;
// - bkt is int32[G], sorted non-decreasing, every value in [0, buckets);
// - drow is int32[G, W]; non-writers carry zero rows.
//
// Design. The TPU kernel swept every store tile and folded its updates in
// with one-hot matmuls on the MXU (split into four 8-bit parts to stay
// exact in bf16). None of that carries over: Hopper has no reason to touch
// rows nobody updates. Here the update stream is cut into chunks of kRows
// consecutive rows, one warp per chunk; each lane owns one 16-byte vector
// of the row (a 128-lane row is one coalesced 512-byte warp access).
//   1. The warp loads its chunk's kRows delta vectors at once (independent
//      loads, so they are in flight together) and its kRows bucket ids.
//   2. A segmented sum in registers, in uint32 (the wrap is the arithmetic
//      the decide relies on: old + (new - old) = new mod 2^32), leaves each
//      run of equal buckets summed at its last row.
//   3. Each run is added into its store row ONCE. A run wholly inside the
//      chunk belongs to this warp alone: plain load-add-store, the loads of
//      all such runs in flight together. Only a run that continues into the
//      previous or next chunk (bkt[first] == bkt[first-1] or bkt[last] ==
//      bkt[last+1]) shares its row with another warp; it is added with
//      integer atomicAdd (zero components skipped). Integer atomics commute,
//      so the result is exact and independent of order. Since a bucket's
//      rows are one contiguous run, a row is never written both ways.
// A first design gave each run to the warp of its leader row, with no
// atomics at all; it serialised long runs in one warp, and the decide's
// padded group tail is one run of hundreds of zero rows (PERF.md).
//
// Bound: bytes, not operations. The function must read G*W*4 bytes of
// drow and G*4 of bkt, and read and write the U touched store rows,
// 2*U*W*4 bytes; it does one add per int32 it reads. At the decide's
// shapes (G <= 32768, W = 128) that is at most ~48 MiB, so launch latency
// dominates at the top of the ladder and memory latency below it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRows = 8;  // delta rows per warp

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ void atomic_add4(uint4* dst, uint4 v) {
  unsigned int* p = reinterpret_cast<unsigned int*>(dst);
  if (v.x) atomicAdd(p + 0, v.x);
  if (v.y) atomicAdd(p + 1, v.y);
  if (v.z) atomicAdd(p + 2, v.z);
  if (v.w) atomicAdd(p + 3, v.w);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
writeback_add_kernel(int32_t* __restrict__ data,
                     const int32_t* __restrict__ bkt,
                     const int32_t* __restrict__ drow,
                     int g, int nvec, int buckets) {
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int base = chunk * kRows;
  if (base >= g || lane >= nvec) return;
  const int n = min(kRows, g - base);

  const uint4* src = reinterpret_cast<const uint4*>(drow);
  uint4* dst = reinterpret_cast<uint4*>(data);
  int b[kRows];
  uint4 v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < n) {
      b[r] = bkt[base + r];
      v[r] = src[static_cast<size_t>(base + r) * nvec + lane];
    } else {
      b[r] = -1;  // never equal to an in-range bucket
      v[r] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const int prev = base > 0 ? bkt[base - 1] : -1;
  const int next = base + kRows < g ? bkt[base + kRows] : -1;

  // segmented inclusive sum: v[r] holds its run's sum where the run ends
#pragma unroll
  for (int r = 1; r < kRows; ++r) {
    if (b[r] == b[r - 1]) v[r] = add4(v[r], v[r - 1]);
  }

  bool own[kRows];
  uint4 old[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool end = r < n && (r == kRows - 1 || b[r + 1] != b[r]);
    const bool in_range = b[r] >= 0 && b[r] < buckets;
    const bool shared = b[r] == prev || b[r] == next;
    own[r] = end && in_range && !shared;
    if (end && in_range && shared) {
      atomic_add4(dst + static_cast<size_t>(b[r]) * nvec + lane, v[r]);
    }
    if (own[r]) old[r] = dst[static_cast<size_t>(b[r]) * nvec + lane];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (own[r]) dst[static_cast<size_t>(b[r]) * nvec + lane] = add4(old[r], v[r]);
  }
}

// The copy floor: x[i] += 1 over n int32, in place.
//
// Replaces the identity sweep of scripts/bench_hbm.py (`kern` inside
// `ident`, :92: out = data + 1 over the store in tiles of 128-8,192 rows),
// a microbenchmark that measures the least time any pass over the store
// can take. Each thread owns 16-byte vectors in a grid-stride loop, so
// every load is a coalesced 512-byte warp access; a tail of n % 4 int32
// (none at the store's shapes) is done one int32 at a time. Bound: bytes
// (read and write 4n each), one add per int32. (Issuing four loads before
// their stores measured no faster on the H100, PERF.md.)
__global__ void __launch_bounds__(256)
add_one_kernel(int32_t* __restrict__ x, long long n) {
  const long long nvec = n / 4;
  uint4* v = reinterpret_cast<uint4*>(x);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4 one = make_uint4(1u, 1u, 1u, 1u);
  for (long long i = start; i < nvec; i += stride) {
    v[i] = add4(v[i], one);
  }
  for (long long i = nvec * 4 + start; i < n; i += stride) {
    x[i] = static_cast<int32_t>(static_cast<uint32_t>(x[i]) + 1u);
  }
}

}  // namespace

// Launches on `stream` (the caller's current CUDA stream) and returns the
// cudaGetLastError() code of the launch: 0 on success.
extern "C" int guber_writeback_add(void* data, const void* bkt,
                                   const void* drow, int g, int w,
                                   int buckets, void* stream) {
  if (g <= 0) return 0;
  const int nvec = w / 4;
  const int chunks = (g + kRows - 1) / kRows;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  writeback_add_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(data), static_cast<const int32_t*>(bkt),
      static_cast<const int32_t*>(drow), g, nvec, buckets);
  return static_cast<int>(cudaGetLastError());
}

// x[i] += 1 over n int32 in place, on `stream`; returns the launch's
// cudaGetLastError() code. `sms` is the device's SM count: the grid is a
// few blocks per SM, each looping over the array.
extern "C" int guber_add_one(void* x, long long n, int sms, void* stream) {
  if (n <= 0) return 0;
  const long long want = (n / 4 + 255) / 256;
  const int grid = static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  add_one_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(x), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* guber_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
