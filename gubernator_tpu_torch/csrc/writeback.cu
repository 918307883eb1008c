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
// - bkt is int32[G], sorted non-decreasing; rows whose bucket lies outside
//   [0, buckets) (the sentinel -1) are skipped;
// - drow is int32[G, W]; non-writers carry zero rows.
//
// Bound: bytes, not operations. The function must read G*W*4 bytes of
// drow and G*4 of bkt, and read and write the U touched store rows,
// 2*U*W*4 bytes; it does one add per int32 it reads. At the decide's
// G = 8,192 (W = 128, U ~ 7,500) that is ~12 MB, 3.56 us at 3.35 TB/s:
// the whole stream fits in one wave of the card, so the time is the
// launch, two dependent memory latencies and the transfer.
//
// Design. The TPU kernel swept every store tile and folded its updates in
// with one-hot matmuls on the MXU. None of that carries over: Hopper has
// no reason to touch rows nobody updates. Here the update stream is cut
// into tiles of kTile consecutive rows, one block a tile and one warp a
// row; lane l owns the row's 16-byte vector l (a 128-lane row is one
// coalesced 512-byte warp access). At G = 8,192 that is 1,024 blocks of
// 8 warps, all resident at once (24 registers a thread; the launch bounds
// cap it at 32, so an SM holds 64 warps).
//   1. Each lane issues its delta vector's load first (evict-first: the
//      stream is read once), then the row's bucket id and its neighbours'
//      (bkt[row + 1], and the tile's first row and the one before it).
//   2. As soon as those land, the lane of a run's last row in the tile
//      issues the load of its store row, while the delta loads are still
//      in flight: the store-row gather no longer waits for the deltas.
//   3. The delta vectors and bucket ids go to shared memory; after one
//      barrier each run's last row sums its run's earlier rows in the tile
//      from there (uint32: the wrap is the arithmetic the decide relies
//      on, old + (new - old) = new mod 2^32).
//   4. Each run is added into its store row once. A run wholly inside the
//      tile belongs to this block alone: plain load-add-store. A run that
//      continues into the tile before or after (bkt[first] == bkt[first-1]
//      or bkt[last] == bkt[last+1]) shares its row with another block; its
//      tile's part is added with integer atomicAdd, zero components
//      skipped. Integer atomics commute, so the result is exact and
//      independent of order, and since a bucket's rows are one contiguous
//      run, a row is never written both ways. The decide's padded group
//      tail (one run of hundreds of zero rows) is thus one atomic-free sum
//      a tile, in parallel, never a serial walk in one warp (an earlier
//      design did that).
//   5. The launch is a programmatic dependent launch: the grid may be
//      scheduled while the kernel before it in the stream drains, and
//      waits (griddepcontrol.wait) for that kernel's memory before its
//      first read; once its loads are issued it lets the next grid start
//      launching. Stream capture records it as a programmatic edge (the
//      card test reads the edge's type): the decide, install and GLOBAL
//      step graphs replay it so, byte-identical to the eager call.
//
// What each variant took on the card (a one-off sweep, timed in turns in
// one call, each variant held bit for bit against index_add_, eager and
// replayed from a graph; only the product's code remains, and PERF.md
// lists every number). Two-tier shape (G = 8,192, 2^20 buckets),
// us a call: 192 calls over 8 batches on the stream / the 8-batch cycle as
// one CUDA graph / one batch repeated; NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit:
//   chunk K8 (the design this replaced: a warp a chunk of 8 rows in
//     registers, the store loads after the deltas land)
//                                          7.405 / 6.223 / 5.575
//   tile K8, plain loads, plain launch     7.129 / 5.842 / 4.685
//   + evict-first delta loads              5.671 / 4.672 / 4.764
//   + dependent launch: the product        4.326 / 4.347 / 3.571 (82% of
//     the 3.56 us bound; the dependent launch alone 5.303 / 5.174)
//   tile K4 / K16 with both                4.582 / 4.695 (graph 4.640 / 4.596)
//   cp.async gathers into shared memory    7.160 / 5.937 (with the
//     dependent launch 5.320 / 5.230)
//   index_add_                             11.643 / 10.551 / 9.617
// The gather issued early gained 4% alone; the evict-first hints ~20%, and
// the dependent launch ~1.3 us on the stream and ~0.3 us inside a graph.
// Those times are of writebacks run back to back, where each writeback
// lets the next one start launching early. On the paths the kernel runs
// after the decide's torch kernels, in one graph replay; there
// (chip_smoke.py --decide-profile, torch.profiler over 20 graphed
// decides, each variant built from its own checkout, two passes in
// turns, same card) it took, us a call exact / two-tier: the product
// 3.868 / 4.419, tile K8 plainly 3.821 / 4.386, with only the hints 3.800
// / 4.408, only the dependent launch 3.857 / 4.364, chunk K8 4.250 /
// 4.801. Inside a decide the hints and the dependent launch gain nothing;
// the tile layout ~0.4 us. The product keeps both: they cost nothing
// there and win back to back. The exact shape (2^21 buckets) read within
// 4% of the back-to-back times above. At 4,096 buckets and G = 32,768 (runs
// of ~8 rows) K16 led (9.418 us, K8 10.567, chunk K8 12.569); the product
// runs the paths' shape's best, K8.
//
// kTile is a template parameter: the product entry guber_writeback_add
// runs kProductTile = 8; guber_writeback_add_rows (the ablation's `full`)
// runs the same kernel at kTile = krows in {4, 8, 16}.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;  // the rows step's warps a block
constexpr int kProductTile = 8;    // rows a tile in the product

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

template <int kTile>
__global__ void __launch_bounds__(kTile * 32, 2048 / (kTile * 32))
writeback_add_kernel(int32_t* __restrict__ data,
                     const int32_t* __restrict__ bkt,
                     const int32_t* __restrict__ drow,
                     int g, int nvec, int buckets) {
  __shared__ uint4 part[kTile][32];
  __shared__ int bs[kTile];
  grid_dependency_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = blockIdx.x * kTile;
  const int row = base + warp;
  const int last = min(base + kTile, g) - 1;  // the tile's last row
  uint4* dst = reinterpret_cast<uint4*>(data);
  uint4 v = make_uint4(0u, 0u, 0u, 0u), old;
  int b = -1;
  bool own = false, shared = false;
  if (row <= last) {
    const bool active = lane < nvec;
    const uint4* src = reinterpret_cast<const uint4*>(drow) +
                       static_cast<size_t>(row) * nvec + lane;
    if (active) v = __ldcs(src);
    b = bkt[row];
    const int after = row + 1 < g ? bkt[row + 1] : -1;
    const int head = bkt[base];
    const int before = base > 0 ? bkt[base - 1] : -1;
    const bool end = row == last || after != b;
    const bool in_range = b >= 0 && b < buckets;
    // the run continues into the next tile, or began in the one before
    const bool crosses = (row == last && after == b) || (b == head && before == b);
    own = active && end && in_range && !crosses;
    shared = active && end && in_range && crosses;
    if (own) old = dst[static_cast<size_t>(b) * nvec + lane];
    part[warp][lane] = v;
    if (lane == 0) bs[warp] = b;
  }
  grid_launch_dependents();
  __syncthreads();
  if (!own && !shared) return;
  uint4 acc = v;  // plus the run's earlier rows in the tile
  for (int r = warp - 1; r >= 0 && bs[r] == b; --r) acc = add4(acc, part[r][lane]);
  uint4* out = dst + static_cast<size_t>(b) * nvec + lane;
  if (own) {
    *out = add4(old, acc);
  } else {
    atomic_add4(out, acc);
  }
}

// The writeback ablation: which step of the writeback costs the time.
//
// Replaces scripts/ablate_sweep.py's `kernel` (inside `make`, :43; its
// pl.pallas_call at :119), which timed three modes of the TPU sweep: the
// tile copy, plus the chunk DMA, plus the one-hot matmul. Those modes
// ablate TPU mechanics that this kernel does not have, so the Hopper port
// ablates the Hopper writeback instead, as three functions that are each
// exactly defined and each held against a plain PyTorch version:
//   rows    the store side alone: for every run of equal buckets, load
//           the touched store row and store it back plus one in every
//           int32 (the +1 makes the store observable: a row skipped,
//           touched twice or the wrong row shows). Bytes: 2*U*W*4 + G*4.
//   deltas  the delta stream alone: read every delta row and bucket id and
//           reduce each run of equal buckets within a chunk of kRows rows
//           (the segmented sum writeback_add does a tile) into
//           out[run end]; other rows of out are not written. The store is
//           not touched. Bytes: G*W*4 + G*4 read, the run ends' rows
//           written. Its own design follows (ablate_deltas_kernel).
//   full    writeback_add itself, at kTile = kRows in {4, 8, 16}.

template <int kRows>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ablate_rows_kernel(int32_t* __restrict__ data, const int32_t* __restrict__ bkt,
                   int g, int nvec, int buckets) {
  const int chunk = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int base = chunk * kRows;
  if (base >= g || lane >= nvec) return;
  const int n = min(kRows, g - base);
  uint4* dst = reinterpret_cast<uint4*>(data);
  int b[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) b[r] = r < n ? bkt[base + r] : -1;
  const int next = base + n < g ? bkt[base + n] : -1;
  bool end[kRows];
  uint4 row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // a run's last row, in the whole stream: each run is touched once
    const int after = r + 1 < n ? b[r + 1] : next;
    end[r] = r < n && after != b[r] && b[r] >= 0 && b[r] < buckets;
    if (end[r]) row[r] = dst[static_cast<size_t>(b[r]) * nvec + lane];
  }
  const uint4 one = make_uint4(1u, 1u, 1u, 1u);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (end[r]) dst[static_cast<size_t>(b[r]) * nvec + lane] = add4(row[r], one);
  }
}

// The deltas step, designed for the H100: one warp a row, kDeltaChunks
// chunks a block. Each lane loads its row's one 16-byte vector, evict-first
// (the stream is read once), into shared memory with the row's bucket id;
// after one barrier the lane of each run end sums its run from there and
// stores it, evict-first. Unless the caller turns it off, the launch is a
// programmatic dependent launch: the grid may be scheduled while the kernel
// before it in the stream finishes, and waits (griddepcontrol.wait) for
// that kernel's memory before it reads anything; once its loads are in
// flight it lets the next grid start launching (writeback_add launches so
// too).
//
// Bound: bytes (at the two-tier path's G = 8,192, W = 128: 4 MiB read,
// ~3.8 MB written). What a variant sweep found on the H100 (PERF.md lists
// every variant): the design this replaces, a warp a chunk with kRows
// vectors a lane in registers (128 blocks of 8 warps, one partial wave),
// took 6.6 us cycling 8 batches against 3.5 us on one batch repeated in
// the L2: cold HBM, not the partial wave, made most of its gap to the rows
// step. More and smaller warps gained 7%, the evict-first hints 13% more
// (~5.3 us, ~45% of the bound); 1-D TMA bulk copies of each chunk through
// a shared-memory ring lost. Back to back a kernel costs ~2 us however
// little it does, and the dependent launch overlaps that with the call
// before: 4.1 us, 58% of the bound, but only where the kernel before it is
// one that the overlap can hide behind.
constexpr int kDeltaChunks = 2;

template <int kRows>
__global__ void ablate_deltas_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ bkt,
                                     const int32_t* __restrict__ drow, int g, int nvec) {
  __shared__ uint4 rows[kDeltaChunks * kRows][32];
  __shared__ int bs[kDeltaChunks * kRows];
  grid_dependency_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDeltaChunks * kRows + warp;
  const int r = warp % kRows;      // the row's place in its chunk
  const int first = warp - r;      // the chunk's first row in the block
  const int n = min(kRows, g - (row - r));  // the chunk's rows in range
  if (row < g) {
    if (lane == 0) bs[warp] = bkt[row];
    if (lane < nvec) {
      rows[warp][lane] = __ldcs(reinterpret_cast<const uint4*>(drow) +
                                static_cast<size_t>(row) * nvec + lane);
    }
  }
  grid_launch_dependents();
  __syncthreads();
  if (row >= g || lane >= nvec) return;
  const int b = bs[warp];
  if (r == n - 1 || bs[warp + 1] != b) {
    uint4 acc = rows[warp][lane];
    for (int q = warp - 1; q >= first && bs[q] == b; --q) acc = add4(acc, rows[q][lane]);
    __stcs(reinterpret_cast<uint4*>(out) + static_cast<size_t>(row) * nvec + lane, acc);
  }
}

// The copy floor: x[i] += 1 over n int32, in place.
//
// Replaces the identity sweep of scripts/bench_hbm.py (`kern` inside
// `ident`, :92: out = data + 1 over the store in tiles of 128-8,192 rows),
// a microbenchmark that measures the least time any pass over the store
// can take. Bound: bytes (read and write 4n each), one add per int32.
//
// Design: two kernels, and the entry picks by whether the array fits in
// half the L2.
// - Beyond it (the stores, 512 MiB and 1 GiB): a one-shot grid, one
//   16-byte vector a thread, 256 threads a block, 32-bit offsets, and
//   evict-first hints (__ldcs/__stcs: each byte is touched once); the last
//   block adds the n % 4 int32 past the last vector.
// - Within it (16 MiB): a grid-stride loop over 8 blocks of 256 threads a
//   SM, which nvcc unrolls four vectors deep.
// What a variant sweep found on the H100 (PERF.md lists every variant):
// x.add_(1) is ATen's vectorized_elementwise_kernel, one-shot: 131,072
// blocks of 128 threads at 512 MiB, two vectors a thread, and a one-shot
// kernel of that shape times the same. Beyond the L2 the grid-stride loop
// was 5% slower than it and one vector a thread with the hints 0.6%
// faster; within the L2 the loop was 10% faster than it and every one-shot
// shape slower. More vectors a thread, 1-D TMA bulk copies through a
// shared-memory ring, and a bulk reduce-add that leaves the add to the L2
// were all slower beyond the L2.
__global__ void __launch_bounds__(256)
add_one_stream_kernel(int32_t* __restrict__ x, int nvec, int tail) {
  uint4* v = reinterpret_cast<uint4*>(x);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nvec) __stcs(v + i, add4(__ldcs(v + i), make_uint4(1u, 1u, 1u, 1u)));
  if (tail && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    int32_t* t = x + static_cast<long long>(nvec) * 4 + threadIdx.x;
    *t = static_cast<int32_t>(static_cast<uint32_t>(*t) + 1u);
  }
}

__global__ void __launch_bounds__(256)
add_one_resident_kernel(int32_t* __restrict__ x, long long n) {
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

// The rows step: one warp per chunk of kRows rows, kWarpsPerBlock warps a
// block.
template <int kRows>
dim3 chunk_grid(int g) {
  const int chunks = (g + kRows - 1) / kRows;
  return dim3((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// One block a tile of kTile rows, as a programmatic dependent launch.
template <int kTile>
int launch_writeback_add(void* data, const void* bkt, const void* drow,
                         int g, int w, int buckets, void* stream) {
  return launch_ex(writeback_add_kernel<kTile>, dim3((g + kTile - 1) / kTile),
                   dim3(kTile * 32), true, stream, static_cast<int32_t*>(data),
                   static_cast<const int32_t*>(bkt), static_cast<const int32_t*>(drow), g,
                   w / 4, buckets);
}

template <int kRows>
int launch_ablate_rows(void* data, const void* bkt, int g, int w, int buckets,
                       void* stream) {
  ablate_rows_kernel<kRows>
      <<<chunk_grid<kRows>(g), kWarpsPerBlock * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<int32_t*>(data), static_cast<const int32_t*>(bkt), g,
          w / 4, buckets);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_ablate_deltas(void* out, const void* bkt, const void* drow, int g, int w,
                         bool overlap, void* stream) {
  const int chunks = (g + kRows - 1) / kRows;
  return launch_ex(ablate_deltas_kernel<kRows>,
                   dim3((chunks + kDeltaChunks - 1) / kDeltaChunks),
                   dim3(kDeltaChunks * kRows * 32), overlap, stream,
                   static_cast<int32_t*>(out), static_cast<const int32_t*>(bkt),
                   static_cast<const int32_t*>(drow), g, w / 4);
}

}  // namespace

// Launches on `stream` (the caller's current CUDA stream) and returns the
// cudaGetLastError() code of the launch: 0 on success.
extern "C" int guber_writeback_add(void* data, const void* bkt,
                                   const void* drow, int g, int w,
                                   int buckets, void* stream) {
  if (g <= 0) return 0;
  return launch_writeback_add<kProductTile>(data, bkt, drow, g, w, buckets, stream);
}

// The ablation's entries (see above): `krows` is 4, 8 or 16; any other
// value returns cudaErrorInvalidValue without a launch. The `full` step is
// guber_writeback_add_rows, the product's design at each tile height.
extern "C" int guber_writeback_add_rows(void* data, const void* bkt,
                                        const void* drow, int g, int w,
                                        int buckets, int krows, void* stream) {
  if (g <= 0) return 0;
  switch (krows) {
    case 4: return launch_writeback_add<4>(data, bkt, drow, g, w, buckets, stream);
    case 8: return launch_writeback_add<8>(data, bkt, drow, g, w, buckets, stream);
    case 16: return launch_writeback_add<16>(data, bkt, drow, g, w, buckets, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int guber_ablate_rows(void* data, const void* bkt, int g, int w,
                                 int buckets, int krows, void* stream) {
  if (g <= 0) return 0;
  switch (krows) {
    case 4: return launch_ablate_rows<4>(data, bkt, g, w, buckets, stream);
    case 8: return launch_ablate_rows<8>(data, bkt, g, w, buckets, stream);
    case 16: return launch_ablate_rows<16>(data, bkt, g, w, buckets, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// `overlap` nonzero makes the deltas launch a programmatic dependent one.
extern "C" int guber_ablate_deltas(void* out, const void* bkt, const void* drow,
                                   int g, int w, int krows, int overlap,
                                   void* stream) {
  if (g <= 0) return 0;
  switch (krows) {
    case 4: return launch_ablate_deltas<4>(out, bkt, drow, g, w, overlap, stream);
    case 8: return launch_ablate_deltas<8>(out, bkt, drow, g, w, overlap, stream);
    case 16: return launch_ablate_deltas<16>(out, bkt, drow, g, w, overlap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x[i] += 1 over n int32 in place, on `stream` (x 16-byte aligned);
// returns the launch's cudaGetLastError() code. The kernel follows the
// current device's L2 and SM count (see above). Beyond half the L2 the
// one-shot kernel's offsets are 32-bit: there, 2^31 - 256 vectors or more
// return cudaErrorInvalidValue without a launch (the wrapper raises). The
// loop within half the L2 has 64-bit offsets and no such limit.
extern "C" int guber_add_one(void* x, long long n, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, l2 = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int32_t* p = static_cast<int32_t*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nvec = n / 4;
  if (n * 4 <= l2 / 2) {
    const long long want = (nvec + 255) / 256;
    const int grid = static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
    add_one_resident_kernel<<<grid, 256, 0, st>>>(p, n);
  } else {
    if (nvec >= (1LL << 31) - 256) return static_cast<int>(cudaErrorInvalidValue);
    add_one_stream_kernel<<<static_cast<int>((nvec + 255) / 256), 256, 0, st>>>(
        p, static_cast<int>(nvec), static_cast<int>(n % 4));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* guber_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
