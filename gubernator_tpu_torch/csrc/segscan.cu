// Segmented scans of the decide, for Hopper (sm_90a).
//
// Three functions of a leader flag per row (lead, uint8[n], 0 or 1) over
// contiguous segments, each one segment starting at every flagged row and
// the first at row 0 whether flagged or not:
//
//   sum    out[i, c] = the saturating sum of vals[j, c] over the rows j <= i
//          of i's segment, for int32 vals[n, k] >= 0, 1 <= k <= 17: each
//          column's segmented inclusive prefix, clamped at 2^31 - 1 (with no
//          lead, a segment every `width` rows: a prefix along each row of a
//          [n / width, width] matrix, as `vals` [n, 1]);
//   start  out[i] = the first row of i's segment (0 before the first flag);
//   end    out[i] = the last row of i's segment (the row before the next
//          flag, n - 1 for the final segment).
//
// Replaces no Pallas kernel. It replaces the JAX package's
// `lax.associative_scan` calls in gubernator_tpu/core/kernels.py: `_seg_scan`
// (the saturating add under the (flag, value) construction, :244-260) and
// `_segment_ends` (the reverse min-scan, :264-269), together with the
// cumulative max that derives each row's segment start in the port, and
// the writeback plan's jnp.cumsum along each group's ways (:357). The port
// had run them as torch's cummax, cummin and int64 cumsum around transposes
// and flips; the installed torch launches its scan along the innermost
// dimension with ceil(rows / threads.y) blocks, so a 1-D scan of 32,768 rows
// is one block of the card's 132 SMs, walking the array in serial chunks
// (67-89 us a call measured inside the decide graphs), an [N, K] scan over
// its transpose is K blocks, and its scan along the rows of an int32
// [32768, 16] took 221 us on an H100 (13 us at [8192, 16]).
//
// Bound: bytes, and at the decide's sizes the latency of a few dependent
// memory round trips. A sum reads n*k*4 bytes of values and n of flags and
// writes n*k*4; start and end read n flags and write n*4. At the decide's
// largest call (n = 32,768 groups, k = 17: the writeback plan's miss rank
// and its 16 found-way counts) that is 4.5 MB, 1.3 us at 3.35 TB/s, and the
// values were written by the kernel just before, so they are read from the
// 50 MB L2; the row-level sums (k = 2) move 0.5 MB.
//
// Design. The time is latency, not bandwidth: one warp's chain of dependent
// loads, shuffles and adds, and the two launches. So the array is cut into
// small tiles, 32 * kRows rows, one warp a tile (4 warps a block): a
// 32,768-row call runs on 512 (up to 4 columns) or 1,024 warps spread over
// the SMs, and a 64-row call is one warp. Two grids, both launched as
// programmatic dependent launches (pdl.cuh), so each may be scheduled while
// the kernel before it drains:
//   1. totals: each warp but the last loads its tile and reduces it to the
//      tile's (any flag, sum after its last flag) into a scratch row;
//   2. scan: each warp issues its tile's loads, folds the totals of the
//      tiles before it back to the nearest one that holds a flag (32 tiles
//      a step, a ballot finds the flag; one step at the decide's segment
//      lengths) into its carry while they land, and scans its tile from
//      that carry.
// A tile is staged through shared memory: the warp reads its rows
// coalesced, 128 contiguous bytes an instruction, every load issued before
// the first is used, and each lane then walks its kRows contiguous rows
// there (row and lane strides are odd, so no two lanes of a read share a
// bank). Within the warp the lanes' partial folds are combined by a shuffle
// scan (5 steps). One tile needs no totals grid. Nothing persists
// between calls: the totals scratch is written by grid 1 of the same call
// before grid 2 reads it (grid 2 waits on grid 1 with griddepcontrol.wait),
// so a captured call replays without a reset, and nothing here allocates
// or synchronises.
//
// The width k is a runtime value; the kernel is compiled for the widest
// column count of four classes (1, 2, 4, 17), which fixes the tile height
// (kRows = 2 rows a lane up to 4 columns, 1 above) and the staging size
// (at most 8.8 KB of static shared memory a block). "end" walks the rows
// from the last to the first and counts rows to the segment's end.
//
// What the tile height took on the card (a one-off sweep of this source at
// other kRows, each held bit for bit against the plain versions; us a call,
// totals + scan grid back to back, NVIDIA H100 80GB HBM3 at 700 W): at 16 /
// 4 rows a lane (up to 4 columns / 17) 32,768 x 2 took 15.2, 32,768 x 17
// 26.0 and the 32,768-row ends 8.5; 4 / 4 took 6.9, 27.0, 4.6; 4 / 1 took
// 6.9, 12.0, 4.6; 2 / 1, this source, 5.0, 12.0, 3.6 (the [32768, 16] row
// prefix 9.8; 8.3 at 4 rows a lane). Fewer rows a lane, more warps, less
// latency on each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"

namespace {

constexpr int kScanWarps = 4;  // warps a block, one tile each
constexpr int32_t kI32Max = 0x7fffffff;
constexpr int kMaxColumns = 17;

enum : int { kModeSum = 0, kModeStart = 1, kModeEnd = 2 };

template <int KMAX>
struct ScanGeo {
  static constexpr int kRows = KMAX <= 4 ? 2 : 1;                // rows a lane
  static constexpr int kRowStride = KMAX | 1;                    // a staged row, odd
  static constexpr int kLaneStride = (kRows * kRowStride) | 1;   // a lane's rows, odd
  static constexpr int kTile = 32 * kRows;                       // rows a warp
  // the staged position of the tile's local row r
  __device__ static int at(int r) {
    return (r / kRows) * kLaneStride + (r % kRows) * kRowStride;
  }
};

struct ScanArgs {
  const uint8_t* lead;  // [n]
  const int32_t* vals;  // [n, k] (sum) or null
  int32_t* out;         // [n, k] (sum) or [n]
  int32_t* totals;      // [tiles - 1, KMAX + 1]: flag, then k sums
  int n, k, mode, width, tiles;  // width > 0: a segment every width rows, no lead
};

// A fold of rows: whether it holds a flag, and each column's sum after the
// last flag (of every row where none).
template <int KMAX>
struct Seg {
  int f;
  int32_t v[KMAX];
};

template <int KMAX>
__device__ __forceinline__ Seg<KMAX> empty_seg() {
  Seg<KMAX> s;
  s.f = 0;
#pragma unroll
  for (int c = 0; c < KMAX; ++c) s.v[c] = 0;
  return s;
}

// a + b clamped at 2^31 - 1, for a, b in [0, 2^31 - 1]: associative there,
// so every grouping of the adds gives the same sum.
__device__ __forceinline__ int32_t sat_add(int32_t a, int32_t b) {
  const uint32_t s = static_cast<uint32_t>(a) + static_cast<uint32_t>(b);
  return s > static_cast<uint32_t>(kI32Max) ? kI32Max : static_cast<int32_t>(s);
}

template <int KMAX>
struct TileStage {
  int32_t vals[32 * ScanGeo<KMAX>::kLaneStride];
  uint8_t flags[ScanGeo<KMAX>::kTile];
};

// A lane's share of a tile in registers: its loads are all issued before
// any is used (staged through shared memory one by one, each load would
// wait for the one before).
template <int KMAX>
struct TileRegs {
  int32_t v[ScanGeo<KMAX>::kRows * KMAX];
  uint8_t f[ScanGeo<KMAX>::kRows];
};

// Load the tile's flags (in scan order) and, for a sum, its values, 128
// contiguous bytes a warp instruction: lane l takes rows i * 32 + l and
// flat elements i * 32 + l.
template <int KMAX>
__device__ __forceinline__ TileRegs<KMAX> fetch_tile(const ScanArgs& a, long long row0, int rows,
                                                     int lane) {
  using G = ScanGeo<KMAX>;
  TileRegs<KMAX> t;
#pragma unroll
  for (int i = 0; i < G::kRows; ++i) {
    const int r = i * 32 + lane;
    uint8_t f = 0;
    if (r < rows) {
      const long long l = row0 + r;
      if (a.mode == kModeEnd) {
        // walking backwards, a segment starts at each segment's last row
        const long long p = a.n - 1 - l;
        f = p == a.n - 1 || __ldg(a.lead + p + 1) != 0;
      } else {
        f = a.width > 0 ? l % a.width == 0 : __ldg(a.lead + l) != 0;
      }
    }
    t.f[i] = f;
  }
  if (a.mode == kModeSum) {
    const int total = rows * a.k;
    const int32_t* src = a.vals + row0 * a.k;
#pragma unroll
    for (int i = 0; i < G::kRows * KMAX; ++i) {
      t.v[i] = i * 32 + lane < total ? __ldg(src + i * 32 + lane) : 0;
    }
  }
  return t;
}

// Stage a fetched tile in shared memory, each row where the lane that
// walks it reads it.
template <int KMAX>
__device__ __forceinline__ void stage_tile(const ScanArgs& a, const TileRegs<KMAX>& t, int lane,
                                           TileStage<KMAX>& st) {
  using G = ScanGeo<KMAX>;
#pragma unroll
  for (int i = 0; i < G::kRows; ++i) st.flags[i * 32 + lane] = t.f[i];
  if (a.mode == kModeSum) {
    const int k = a.k;
    // flat element e = i * 32 + lane is row e / k, column e % k; both are
    // stepped by 32 elements without a division
    int r = lane / k, c = lane - (lane / k) * k;
    const int dr = 32 / k, dc = 32 - (32 / k) * k;
#pragma unroll
    for (int i = 0; i < G::kRows * KMAX; ++i) {
      if (r < G::kTile) st.vals[G::at(r) + c] = t.v[i];
      r += dr;
      c += dc;
      if (c >= k) {
        c -= k;
        ++r;
      }
    }
  }
  __syncwarp();
}

// Fold the lane's rows in order, starting from `run`; with kWrite, store
// each row's result in its staged place (a sum's columns, or the row's
// segment start or end).
template <int KMAX, bool kWrite>
__device__ __forceinline__ Seg<KMAX> lane_fold(const ScanArgs& a, TileStage<KMAX>& st, int lane,
                                               int rows, long long row0, Seg<KMAX> run) {
  using G = ScanGeo<KMAX>;
#pragma unroll
  for (int j = 0; j < G::kRows; ++j) {
    const int r = lane * G::kRows + j;
    if (r < rows) {
      const int f = st.flags[r];
      const int base = G::at(r);
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < a.k) {
          const int32_t x = a.mode == kModeSum ? st.vals[base + c] : 1;
          run.v[c] = f ? x : sat_add(run.v[c], x);
        }
      }
      run.f |= f;
      if (kWrite) {
        if (a.mode == kModeSum) {
#pragma unroll
          for (int c = 0; c < KMAX; ++c) {
            if (c < a.k) st.vals[base + c] = run.v[c];
          }
        } else {
          // run.v[0] counts the segment's rows up to this one
          const long long l = row0 + r;
          st.vals[base] = static_cast<int32_t>(
              a.mode == kModeStart ? l + 1 - run.v[0] : (a.n - 1 - l) + run.v[0] - 1);
        }
      }
    }
  }
  return run;
}

// Inclusive scan of the lanes' folds, lane order.
template <int KMAX>
__device__ __forceinline__ void warp_scan(Seg<KMAX>& s, int k, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(0xffffffffu, s.f, d);
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) {
        const int32_t ov = __shfl_up_sync(0xffffffffu, s.v[c], d);
        if (lane >= d && !s.f) s.v[c] = sat_add(ov, s.v[c]);
      }
    }
    if (lane >= d) s.f |= of;
  }
}

__device__ __forceinline__ int32_t warp_sat_sum(int32_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = sat_add(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

// The carry into `tile`: the totals of the tiles before it folded in order,
// read back only to the nearest tile that holds a flag.
template <int KMAX>
__device__ __forceinline__ Seg<KMAX> carry_in(const ScanArgs& a, int tile, int lane) {
  Seg<KMAX> carry = empty_seg<KMAX>();
  for (int last = tile - 1; last >= 0; last -= 32) {
    const int t = last - lane;
    Seg<KMAX> s = empty_seg<KMAX>();
    if (t >= 0) {
      const int32_t* row = a.totals + static_cast<long long>(t) * (KMAX + 1);
      s.f = row[0];
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < a.k) s.v[c] = row[1 + c];
      }
    }
    const unsigned hit = __ballot_sync(0xffffffffu, s.f != 0);
    // lane h holds the nearest flagged tile: it and the lanes before it
    // (later tiles) count, the lanes after it (earlier tiles) do not
    const int h = hit ? __ffs(hit) - 1 : 31;
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < a.k) carry.v[c] = sat_add(carry.v[c], warp_sat_sum(lane <= h ? s.v[c] : 0));
    }
    if (hit) {
      carry.f = 1;
      break;
    }
  }
  return carry;
}

template <int KMAX>
__global__ void __launch_bounds__(kScanWarps * 32) seg_totals_kernel(ScanArgs a) {
  using G = ScanGeo<KMAX>;
  __shared__ TileStage<KMAX> stage[kScanWarps];
  grid_dependency_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile < a.tiles - 1) {  // the last tile's total feeds no later tile
    const long long row0 = static_cast<long long>(tile) * G::kTile;
    stage_tile<KMAX>(a, fetch_tile<KMAX>(a, row0, G::kTile, lane), lane, stage[warp]);
    Seg<KMAX> s = lane_fold<KMAX, false>(a, stage[warp], lane, G::kTile, row0, empty_seg<KMAX>());
    warp_scan<KMAX>(s, a.k, lane);
    if (lane == 31) {
      int32_t* row = a.totals + static_cast<long long>(tile) * (KMAX + 1);
      row[0] = s.f;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < a.k) row[1 + c] = s.v[c];
      }
    }
  }
  grid_launch_dependents();
}

template <int KMAX>
__global__ void __launch_bounds__(kScanWarps * 32) seg_scan_kernel(ScanArgs a) {
  using G = ScanGeo<KMAX>;
  __shared__ TileStage<KMAX> stage[kScanWarps];
  grid_dependency_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (blockDim.x >> 5) + warp;
  if (tile < a.tiles) {
    TileStage<KMAX>& st = stage[warp];
    const long long row0 = static_cast<long long>(tile) * G::kTile;
    const int rows = a.n - row0 < G::kTile ? static_cast<int>(a.n - row0) : G::kTile;
    // the tile's loads in flight while the carry's are
    const TileRegs<KMAX> regs = fetch_tile<KMAX>(a, row0, rows, lane);
    const Seg<KMAX> carry = carry_in<KMAX>(a, tile, lane);
    stage_tile<KMAX>(a, regs, lane, st);
    Seg<KMAX> s = lane_fold<KMAX, false>(a, st, lane, rows, row0, empty_seg<KMAX>());
    warp_scan<KMAX>(s, a.k, lane);
    // the lane's start: the carry, then the lanes before it
    Seg<KMAX> pre;
    pre.f = __shfl_up_sync(0xffffffffu, s.f, 1);
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      pre.v[c] = c < a.k ? __shfl_up_sync(0xffffffffu, s.v[c], 1) : 0;
    }
    if (lane == 0) pre = empty_seg<KMAX>();
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < a.k && !pre.f) pre.v[c] = sat_add(carry.v[c], pre.v[c]);
    }
    lane_fold<KMAX, true>(a, st, lane, rows, row0, pre);
    __syncwarp();
    if (a.mode == kModeSum) {
      const int k = a.k;
      const int total = rows * k;
      int32_t* dst = a.out + row0 * k;
      int r = lane / k, c = lane - (lane / k) * k;
      const int dr = 32 / k, dc = 32 - (32 / k) * k;
#pragma unroll
      for (int i = 0; i < G::kRows * KMAX; ++i) {
        if (i * 32 + lane < total) dst[i * 32 + lane] = st.vals[G::at(r) + c];
        r += dr;
        c += dc;
        if (c >= k) {
          c -= k;
          ++r;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < G::kRows; ++i) {
        const int r = i * 32 + lane;
        if (r < rows) {
          const long long l = row0 + r;
          a.out[a.mode == kModeEnd ? a.n - 1 - l : l] = st.vals[G::at(r)];
        }
      }
    }
  }
  grid_launch_dependents();
}

template <int KMAX>
long long tiles_of(int n) {
  return (static_cast<long long>(n) + ScanGeo<KMAX>::kTile - 1) / ScanGeo<KMAX>::kTile;
}

template <int KMAX>
long long totals_ints(int n) {
  return (tiles_of<KMAX>(n) - 1) * (KMAX + 1);
}

template <int KMAX>
int launch_seg_scan(ScanArgs a, void* stream) {
  a.tiles = static_cast<int>(tiles_of<KMAX>(a.n));
  if (a.tiles > 1) {
    if (a.totals == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int need = a.tiles - 1;
    const int rc = launch_ex(seg_totals_kernel<KMAX>, dim3((need + kScanWarps - 1) / kScanWarps),
                             dim3(kScanWarps * 32), true, stream, a);
    if (rc != 0) return rc;
  }
  const int warps = a.tiles < kScanWarps ? a.tiles : kScanWarps;
  return launch_ex(seg_scan_kernel<KMAX>, dim3((a.tiles + warps - 1) / warps), dim3(warps * 32),
                   true, stream, a);
}

}  // namespace

// int32 elements of the totals scratch a call of n rows and k columns
// needs (0 for one tile); -1 for a k the kernel does not take.
extern "C" long long guber_seg_scan_totals(int n, int k) {
  if (n <= 0) return 0;
  if (k == 1) return totals_ints<1>(n);
  if (k == 2) return totals_ints<2>(n);
  if (k >= 3 && k <= 4) return totals_ints<4>(n);
  if (k >= 5 && k <= kMaxColumns) return totals_ints<kMaxColumns>(n);
  return -1;
}

// One scan on `stream` (the caller's current CUDA stream): `mode` 0 sums
// vals [n, k] into out [n, k]; 1 and 2 (k = 1, vals null) write each row's
// segment start or end into out [n]. The segments start at the rows `lead`
// flags, or, with `width` > 0 and a sum (lead null), at every width-th row.
// `totals` holds guber_seg_scan_totals(n, k) int32. Returns the launches'
// error code, 0 on success; a k, mode or width the kernel does not take
// returns cudaErrorInvalidValue without a launch.
extern "C" int guber_seg_scan(const void* lead, const void* vals, void* out, void* totals, int n,
                              int k, int mode, int width, void* stream) {
  if (n <= 0) return 0;
  const bool sum = mode == kModeSum;
  if ((mode != kModeSum && mode != kModeStart && mode != kModeEnd) || (sum && vals == nullptr) ||
      (!sum && k != 1) || width < 0 || (width > 0) != (lead == nullptr) || (width > 0 && !sum)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs a = {static_cast<const uint8_t*>(lead), static_cast<const int32_t*>(vals),
                static_cast<int32_t*>(out), static_cast<int32_t*>(totals), n, k, mode, width, 0};
  if (k == 1) return launch_seg_scan<1>(a, stream);
  if (k == 2) return launch_seg_scan<2>(a, stream);
  if (k >= 3 && k <= 4) return launch_seg_scan<4>(a, stream);
  if (k >= 5 && k <= kMaxColumns) return launch_seg_scan<kMaxColumns>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
