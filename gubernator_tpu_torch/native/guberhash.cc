// Batch 64-bit key hashing for the serving hot path.
//
// The serving tier hashes every request key (name + "_" + unique_key) to a
// 64-bit slot hash before shipping the batch to the device. In Python this
// costs ~1us/key (hashlib call overhead); at millions of decisions per
// second host hashing would dominate, so the batch loop lives here. The
// Python side passes one concatenated byte buffer plus an offsets array and
// receives a uint64 array — one FFI call per batch, no per-key overhead.
//
// Hash: XXH64 (Yann Collet's public-domain algorithm, implemented from the
// spec). 64-bit avalanche quality is what the slot store needs: row
// indices and the fingerprint tag are all derived from this one value
// (gubernator_tpu/core/store.py slot_indices/fingerprints).
//
// Build: make -C gubernator_tpu/native   (or scripts in repo Makefile)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / arm64)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t round1(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= round1(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* const end = data + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - P1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = round1(v1, read64(p));
      v2 = round1(v2, read64(p + 8));
      v3 = round1(v3, read64(p + 16));
      v4 = round1(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }

  h += static_cast<uint64_t>(len);

  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }

  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

}  // namespace

extern "C" {

// Hash n byte-slices of one concatenated buffer. offsets has n+1 entries;
// slice i is buf[offsets[i] : offsets[i+1]].
void guber_hash_batch(const uint8_t* buf, const int64_t* offsets, int64_t n,
                      uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] =
        xxh64(buf + offsets[i],
              static_cast<size_t>(offsets[i + 1] - offsets[i]), seed);
  }
}

// crc32 (IEEE, reflected) batch — ring points for peer ownership, matching
// the reference picker's hash function (reference hash.go:40-42).
static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) {
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    }
    crc_table[i] = c;
  }
  crc_init_done = true;
}

void guber_crc32_batch(const uint8_t* buf, const int64_t* offsets, int64_t n,
                       uint32_t* out) {
  if (!crc_init_done) crc_init();
  for (int64_t i = 0; i < n; ++i) {
    uint32_t c = 0xFFFFFFFFu;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      c = crc_table[(c ^ buf[j]) & 0xFF] ^ (c >> 8);
    }
    out[i] = c ^ 0xFFFFFFFFu;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch presort: argsort by (bucket(key_hash), fingerprint(key_hash)) — the
// order decide_presorted requires (core/kernels.py). numpy's comparison
// argsort measured ~1.8ms for 16k keys, slower than the device batch it
// feeds; this LSD radix sort runs ~15x faster and keeps the host side of
// the pipeline off the critical path. Must stay bit-identical to
// core/store.py group_sort_key / bucket_index / fingerprints.

namespace {

constexpr uint64_t BUCKET_SALT = 0x9E3779B97F4A7C15ULL;
// must match gubernator_tpu/parallel/sharded.py _SHARD_SALT
constexpr uint64_t SHARD_SALT = 0xA24BAED4963EE407ULL;

inline uint64_t splitmix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Stable LSD radix argsort of `keys` (low `total_bits` bits meaningful);
// writes the permutation into order_out.
void radix_argsort(std::vector<uint64_t>& keys, int64_t n, int total_bits,
                   int32_t* order_out) {
  std::vector<int32_t> idx(n), idx2(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = static_cast<int32_t>(i);
  std::vector<uint64_t> keys2(n);

  const int passes = (total_bits + 15) / 16;
  static thread_local std::vector<uint32_t> count(1 << 16);
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * 16;
    std::memset(count.data(), 0, count.size() * sizeof(uint32_t));
    for (int64_t i = 0; i < n; ++i) {
      ++count[(keys[i] >> shift) & 0xFFFF];
    }
    uint32_t sum = 0;
    for (uint32_t d = 0; d < (1u << 16); ++d) {
      uint32_t c = count[d];
      count[d] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      uint32_t pos = count[(keys[i] >> shift) & 0xFFFF]++;
      keys2[pos] = keys[i];
      idx2[pos] = idx[i];
    }
    keys.swap(keys2);
    idx.swap(idx2);
  }
  std::memcpy(order_out, idx.data(), n * sizeof(int32_t));
}

// Run-major counting argsort for composite run keys (shard/bucket bits)
// that fit a direct histogram: ONE stable counting pass on the run key,
// then a per-run stable fingerprint sort for the rare multi-key runs
// (store load factors keep mean keys/bucket around 1, and duplicate
// rows of ONE key share a fingerprint, so most runs are fp-uniform and
// skip the sort entirely). Output is bit-identical to the LSD radix on
// (run_key<<32 | fp) — fp ascending within a run, ties in input order —
// at ~3x less memory traffic for B=32k. skey/fp are per INPUT row;
// ends_out receives each run's END offset in the sorted order.
void counting_argsort_fp(const uint32_t* skey, const uint32_t* fp,
                         int64_t n, uint64_t space, int32_t* order_out,
                         std::vector<uint32_t>& ends_out) {
  ends_out.assign(space, 0);
  for (int64_t i = 0; i < n; ++i) ++ends_out[skey[i]];
  uint32_t sum = 0;
  for (uint64_t b = 0; b < space; ++b) {  // counts -> start offsets
    uint32_t c = ends_out[b];
    ends_out[b] = sum;
    sum += c;
  }
  for (int64_t i = 0; i < n; ++i) {  // stable scatter; starts -> ends
    order_out[ends_out[skey[i]]++] = static_cast<int32_t>(i);
  }
  int64_t s = 0;
  for (uint64_t b = 0; b < space; ++b) {
    const int64_t e = ends_out[b];
    if (e - s > 1) {
      const uint32_t f0 = fp[order_out[s]];
      bool uniform = true;
      for (int64_t i = s + 1; i < e; ++i) {
        if (fp[order_out[i]] != f0) {
          uniform = false;
          break;
        }
      }
      if (!uniform) {
        std::stable_sort(
            order_out + s, order_out + e,
            [&](int32_t a, int32_t c) { return fp[a] < fp[c]; });
      }
    }
    s = e;
  }
}

// Histograms above this are slower to zero than the radix passes save.
constexpr uint64_t COUNTING_SPACE_MAX = 1ULL << 16;
// The sharded composite (owner|bucket) key gets a larger cap: the bigger
// memset trades against skipping 3-4 radix passes instead of 2-3.
constexpr uint64_t SHARDED_COUNTING_SPACE_MAX = 1ULL << 18;

// Build the sharded run keys (owner << bucket_bits | bucket), per-row
// fingerprints, and per-shard row counts in one pass.
void build_sharded_keys(const uint64_t* key_hash, int64_t n, uint64_t bmask,
                        int bucket_bits, uint64_t n_shards,
                        int64_t* counts_out, std::vector<uint32_t>& sk,
                        std::vector<uint32_t>& fp) {
  sk.resize(n);
  fp.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    uint64_t owner = splitmix64(kh ^ SHARD_SALT) % n_shards;
    ++counts_out[owner];
    uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    sk[i] = static_cast<uint32_t>((owner << bucket_bits) | bkt);
    uint32_t f = static_cast<uint32_t>(kh >> 32);
    if (f == 0) f = 1;
    fp[i] = f;
  }
}

// Walk the sorted runs emitting duplicate-key groups (fp-runs within a
// run key). When group_counts_out is non-null, each group also counts
// toward its owning shard (owner = run_key >> bucket_bits). Returns the
// group count.
int64_t emit_groups(const std::vector<uint32_t>& ends, uint64_t space,
                    const std::vector<uint32_t>& fp, const int32_t* order,
                    int32_t* group_id_out, int32_t* leader_pos_out,
                    int64_t* group_counts_out, int bucket_bits) {
  int64_t g = 0;
  int64_t s = 0;
  for (uint64_t r = 0; r < space; ++r) {
    const int64_t e = ends[r];
    int64_t i = s;
    while (i < e) {
      const uint32_t f = fp[order[i]];
      leader_pos_out[g] = static_cast<int32_t>(i);
      if (group_counts_out) ++group_counts_out[r >> bucket_bits];
      while (i < e && fp[order[i]] == f) {
        group_id_out[i] = static_cast<int32_t>(g);
        ++i;
      }
      ++g;
    }
    s = e;
  }
  return g;
}

// Single-device composite (bucket | fp) fast path; false -> radix.
bool counting_presort(const uint64_t* key_hash, int64_t n, uint64_t buckets,
                      int32_t* order_out, std::vector<uint32_t>& fp_out,
                      std::vector<uint32_t>& ends_out) {
  if (buckets > COUNTING_SPACE_MAX) return false;
  const uint64_t bmask = buckets - 1;
  fp_out.resize(n);
  static thread_local std::vector<uint32_t> bk;
  bk.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    bk[i] = static_cast<uint32_t>(splitmix64(kh ^ BUCKET_SALT) & bmask);
    uint32_t f = static_cast<uint32_t>(kh >> 32);
    if (f == 0) f = 1;
    fp_out[i] = f;
  }
  counting_argsort_fp(bk.data(), fp_out.data(), n, buckets, order_out,
                      ends_out);
  return true;
}

}  // namespace

extern "C" {

// order_out[i] = index of the i-th row in (bucket, fingerprint) order.
// buckets must be a power of two. Stable (equal keys keep input order).
void guber_presort(const uint64_t* key_hash, int64_t n, uint64_t buckets,
                   int32_t* order_out) {
  {
    static thread_local std::vector<uint32_t> fp, ends;
    if (counting_presort(key_hash, n, buckets, order_out, fp, ends)) return;
  }
  const uint64_t bmask = buckets - 1;
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;

  // sort key: (bucket << 32) | fingerprint  — 32 + bucket_bits bits
  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    uint64_t fp = kh >> 32;
    if (fp == 0) fp = 1;
    keys[i] = (bkt << 32) | fp;
  }
  radix_argsort(keys, n, 32 + bucket_bits, order_out);
}

// Batch marshalling: gather-with-permutation + pad in one C pass. The
// serving hot path must build the device request arrays (sorted by the
// presort permutation, clipped to the int32 envelope, padded by
// repeating the last sorted row) and unpermute the responses for every
// batch; the numpy version costs ~40ns/element across six fields
// (~630us/16k batch), this runs in one cache-friendly pass.

void guber_gather_pad_i64_clip(const int64_t* src, const int32_t* order,
                               int64_t n, int64_t b, int64_t lo, int64_t hi,
                               int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = src[order[i]];
    v = v < lo ? lo : (v > hi ? hi : v);
    out[i] = static_cast<int32_t>(v);
  }
  const int32_t fill = n ? out[n - 1] : 0;
  for (int64_t i = n; i < b; ++i) out[i] = fill;
}

void guber_gather_pad_i32(const int32_t* src, const int32_t* order,
                          int64_t n, int64_t b, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[order[i]];
  const int32_t fill = n ? out[n - 1] : 0;
  for (int64_t i = n; i < b; ++i) out[i] = fill;
}

void guber_gather_pad_u64(const uint64_t* src, const int32_t* order,
                          int64_t n, int64_t b, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[order[i]];
  const uint64_t fill = n ? out[n - 1] : 0;
  for (int64_t i = n; i < b; ++i) out[i] = fill;
}

void guber_gather_pad_u8(const uint8_t* src, const int32_t* order,
                         int64_t n, int64_t b, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = src[order[i]];
  const uint8_t fill = n ? out[n - 1] : 0;
  for (int64_t i = n; i < b; ++i) out[i] = fill;
}

// out[order[i]] = sorted[i] for the first n positions of each of `k`
// response arrays laid out back to back ([k, b] row-major), writing into
// k output arrays of length b back to back.
void guber_unpermute_i32(const int32_t* sorted, const int32_t* order,
                         int64_t n, int64_t b, int64_t k, int32_t* out) {
  for (int64_t a = 0; a < k; ++a) {
    const int32_t* s = sorted + a * b;
    int32_t* o = out + a * b;
    for (int64_t i = 0; i < n; ++i) o[order[i]] = s[i];
  }
}

// guber_presort + group structure from the sorted key stream: the runs
// of equal (bucket, fingerprint) ARE the duplicate-key groups whose
// store I/O the kernel compacts (core/kernels.py BatchGroups), and they
// fall out of the sort for one extra O(n) pass. group_id_out[i] = group
// slot of sorted row i; leader_pos_out[g] = first sorted row of group g
// (only the first *n_groups_out entries are written).
void guber_presort_grouped(const uint64_t* key_hash, int64_t n,
                           uint64_t buckets, int32_t* order_out,
                           int32_t* group_id_out, int32_t* leader_pos_out,
                           int64_t* n_groups_out) {
  {
    static thread_local std::vector<uint32_t> fp, ends;
    if (counting_presort(key_hash, n, buckets, order_out, fp, ends)) {
      // groups are runs of equal fp within a bucket run (two distinct
      // key hashes sharing (bucket, fp) merge into one group — exactly
      // the composite-key behavior of the radix path, and of the store,
      // whose tag IS the fp)
      *n_groups_out = emit_groups(ends, buckets, fp, order_out,
                                  group_id_out, leader_pos_out, nullptr, 0);
      return;
    }
  }
  const uint64_t bmask = buckets - 1;
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;

  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    uint64_t fp = kh >> 32;
    if (fp == 0) fp = 1;
    keys[i] = (bkt << 32) | fp;
  }
  std::vector<uint64_t> sorted(keys);  // radix_argsort leaves keys sorted,
  // but the buffer identity depends on pass parity — copy for clarity
  radix_argsort(sorted, n, 32 + bucket_bits, order_out);

  int64_t g = 0;
  uint64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = keys[order_out[i]];
    if (i == 0 || k != prev) {
      leader_pos_out[g] = static_cast<int32_t>(i);
      ++g;
      prev = k;
    }
    group_id_out[i] = static_cast<int32_t>(g - 1);
  }
  *n_groups_out = g;
}

// Mesh-sharded presort: argsort by (owner_shard, bucket, fingerprint) and
// per-shard row counts. owner = splitmix64(kh ^ SHARD_SALT) % n_shards —
// must stay bit-identical to parallel/sharded.py owner_of / owner_of_np.
// Rows of one shard come out contiguous, internally in the (bucket, fp)
// order decide_presorted requires, so the host can slice per-shard
// sub-batches straight out of the permutation (batch-axis sharding over
// the mesh: each chip gets only the rows it owns).
void guber_presort_sharded(const uint64_t* key_hash, int64_t n,
                           uint64_t buckets, uint64_t n_shards,
                           int32_t* order_out, int64_t* counts_out) {
  const uint64_t bmask = buckets - 1;
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;
  int shard_bits = 1;
  while ((1ULL << shard_bits) < n_shards) ++shard_bits;

  for (uint64_t s = 0; s < n_shards; ++s) counts_out[s] = 0;

  if ((n_shards << bucket_bits) <= SHARDED_COUNTING_SPACE_MAX) {
    static thread_local std::vector<uint32_t> sk, fp, ends;
    build_sharded_keys(key_hash, n, bmask, bucket_bits, n_shards,
                       counts_out, sk, fp);
    counting_argsort_fp(sk.data(), fp.data(), n, n_shards << bucket_bits,
                        order_out, ends);
    return;
  }

  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    uint64_t owner = splitmix64(kh ^ SHARD_SALT) % n_shards;
    ++counts_out[owner];
    uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    uint64_t fp = kh >> 32;
    if (fp == 0) fp = 1;
    keys[i] = (owner << (32 + bucket_bits)) | (bkt << 32) | fp;
  }
  radix_argsort(keys, n, 32 + bucket_bits + shard_bits, order_out);
}

// guber_presort_sharded + per-shard group structure: groups are runs of
// equal (owner, bucket, fp) composite keys in the sorted stream (shard
// boundaries break groups automatically — the owner rides the top sort
// bits). group_id_out[i] = GLOBAL group index of sorted row i;
// leader_pos_out[g] = first sorted row of global group g;
// group_counts_out[s] = number of groups owned by shard s.
void guber_presort_sharded_grouped(
    const uint64_t* key_hash, int64_t n, uint64_t buckets,
    uint64_t n_shards, int32_t* order_out, int64_t* counts_out,
    int32_t* group_id_out, int32_t* leader_pos_out,
    int64_t* group_counts_out) {
  const uint64_t bmask = buckets - 1;
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;
  int shard_bits = 1;
  while ((1ULL << shard_bits) < n_shards) ++shard_bits;

  for (uint64_t s = 0; s < n_shards; ++s) {
    counts_out[s] = 0;
    group_counts_out[s] = 0;
  }

  if ((n_shards << bucket_bits) <= SHARDED_COUNTING_SPACE_MAX) {
    static thread_local std::vector<uint32_t> sk, fp, ends;
    build_sharded_keys(key_hash, n, bmask, bucket_bits, n_shards,
                       counts_out, sk, fp);
    const uint64_t space = n_shards << bucket_bits;
    counting_argsort_fp(sk.data(), fp.data(), n, space, order_out, ends);
    emit_groups(ends, space, fp, order_out, group_id_out, leader_pos_out,
                group_counts_out, bucket_bits);
    return;
  }

  std::vector<uint64_t> keys(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t kh = key_hash[i];
    uint64_t owner = splitmix64(kh ^ SHARD_SALT) % n_shards;
    ++counts_out[owner];
    uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    uint64_t fp = kh >> 32;
    if (fp == 0) fp = 1;
    keys[i] = (owner << (32 + bucket_bits)) | (bkt << 32) | fp;
  }
  std::vector<uint64_t> sorted(keys);
  radix_argsort(sorted, n, 32 + bucket_bits + shard_bits, order_out);

  int64_t g = 0;
  uint64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t k = keys[order_out[i]];
    if (i == 0 || k != prev) {
      leader_pos_out[g] = static_cast<int32_t>(i);
      ++group_counts_out[k >> (32 + bucket_bits)];
      ++g;
      prev = k;
    }
    group_id_out[i] = static_cast<int32_t>(g - 1);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-call sharded batch prep: presort + duplicate-key groups + device-array
// marshal, optionally thread-parallel.
//
// The r2 mesh host path was numpy: a native sharded presort followed by
// per-field fancy-indexed gathers and a per-shard Python build_groups loop —
// measured ~4.3ms per 32k batch on one core, ~10x the presort itself, which
// capped a served mesh at a fraction of one chip's throughput (the r2
// verdict's "single-threaded host prep" ceiling). This entry point absorbs
// the whole pipeline into one pass:
//
//   phase A (parallel over row ranges): owner/bucket/fingerprint per row +
//           per-thread shard histograms
//   phase B (serial, O(threads*shards)): stable scatter offsets
//   phase C (parallel over row ranges): partition rows by owning shard
//   phase D (parallel over shards): per-shard stable LSD radix argsort by
//           (bucket, fingerprint) — 8-bit digits, skip-uniform passes —
//           then ONE fused walk emits the sorted permutation, the
//           duplicate-key group structure (engine.build_groups
//           conventions), all six clipped+padded device fields, and
//           take_idx.
//
// Thread count: GUBER_PREP_THREADS env, default hardware_concurrency
// (capped 32); 1 runs everything inline with zero pool overhead. Output is
// bit-identical to the numpy twin (parallel/sharded.py fallbacks) at every
// thread count: phases A/C preserve input order per shard (contiguous
// thread ranges, thread-minor offsets) and the per-shard radix is stable.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <pthread.h>

namespace {

// Forked children inherit lanes_ > 1 but ZERO worker threads (threads
// don't survive fork) — without this flag a child's first prep call
// would park in done_cv_.wait() forever. The atfork child handler flips
// it so children run every phase inline.
std::atomic<bool> g_pool_forked{false};

class PrepPool {
 public:
  static PrepPool& inst() {
    static PrepPool* p = new PrepPool();  // leaked: workers live for the
    // process; a static destructor would race threads parked in wait()
    return *p;
  }
  int lanes() const {
    return g_pool_forked.load(std::memory_order_relaxed) ? 1 : lanes_;
  }

  // Run fn(tid, lanes) on every lane; the caller runs lane 0.
  // Concurrent callers (K prep-worker threads, serve/batcher.py) are
  // serialized on caller_m_: each caller's pooled section runs alone —
  // worker-thread parallelism and in-call pool parallelism compose by
  // time-slicing rather than deadlocking. lanes==1 touches no shared
  // state and skips the lock entirely.
  void run(const std::function<void(int, int)>& fn) {
    if (lanes() == 1) {
      fn(0, 1);
      return;
    }
    std::lock_guard<std::mutex> caller_lock(caller_m_);
    {
      std::unique_lock<std::mutex> lk(m_);
      fn_ = &fn;
      pending_ = lanes_ - 1;
      ++gen_;
    }
    cv_.notify_all();
    fn(0, lanes_);
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    fn_ = nullptr;
  }

 private:
  PrepPool() {
    long t = 0;
    if (const char* e = getenv("GUBER_PREP_THREADS")) t = atol(e);
    if (t <= 0) t = (long)std::thread::hardware_concurrency();
    if (t < 1) t = 1;
    if (t > 32) t = 32;
    lanes_ = (int)t;
    if (lanes_ > 1) {
      pthread_atfork(nullptr, nullptr, [] {
        g_pool_forked.store(true, std::memory_order_relaxed);
      });
    }
    for (int i = 1; i < lanes_; ++i) {
      std::thread th([this, i] { worker(i); });
      th.detach();
    }
  }
  void worker(int tid) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int, int)>* fn;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        fn = fn_;
      }
      (*fn)(tid, lanes_);
      {
        std::unique_lock<std::mutex> lk(m_);
        if (--pending_ == 0) done_cv_.notify_one();
      }
    }
  }

  std::mutex m_, caller_m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int, int)>* fn_ = nullptr;
  uint64_t gen_ = 0;
  int pending_ = 0;
  int lanes_ = 1;
};

// group_rungs twin (core/engine.py group_rungs): {15b/64, b/4, 3b/8, b}
// floored, min 64, deduped ascending. Returns count; writes into out[4].
// MUST stay in lockstep with the Python ladder — the native prep picks
// its G rung here and the bit-identity tests compare against Python.
inline int group_rungs_c(int64_t b, int64_t out[4]) {
  auto rung = [b](int64_t num, int64_t den) {
    int64_t r = b < 64 ? b : ((num * b) / den < 64 ? 64 : (num * b) / den);
    return r > b ? b : r;
  };
  int64_t v[4] = {rung(15, 64), rung(1, 4), rung(3, 8), b};
  // insertion sort + dedup (4 elements)
  for (int i = 1; i < 4; ++i)
    for (int j = i; j > 0 && v[j] < v[j - 1]; --j) std::swap(v[j], v[j - 1]);
  int k = 0;
  for (int i = 0; i < 4; ++i)
    if (k == 0 || v[i] != out[k - 1]) out[k++] = v[i];
  return k;
}

inline int64_t pick_rung(const int64_t* rungs, int64_t n_rungs,
                         int64_t need) {
  for (int64_t i = 0; i < n_rungs; ++i)
    if (rungs[i] >= need) return rungs[i];
  return -1;
}

inline int32_t clip_i64(int64_t v, int64_t lo, int64_t hi) {
  return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
}

}  // namespace

extern "C" {

int64_t guber_prep_threads() { return PrepPool::inst().lanes(); }

namespace {
// GUBER_PREP_DEBUG=1: print per-phase microseconds to stderr
inline bool prep_debug() {
  static const bool on = [] {
    const char* e = getenv("GUBER_PREP_DEBUG");
    return e && *e && *e != '0';
  }();
  return on;
}
inline int64_t now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
}  // namespace

// Returns 0 on success; -1 if a shard's row count exceeds the rung
// ladder top; -2 if g_override is given but smaller than a shard's group
// count. picked_out: {B_sub, G_sub}. Output buffers are caller-allocated
// for n_shards rows of the ladder-top rung; rows are written compactly
// with stride B_sub (fields / gid), G_sub (group arrays).
int64_t guber_prep_sharded(
    const uint64_t* key_hash, const int64_t* hits, const int64_t* limit,
    const int64_t* duration, const int32_t* algo, const uint8_t* gnp,
    int64_t n, uint64_t buckets, int64_t n_shards, const int64_t* rungs,
    int64_t n_rungs, int64_t g_override, int64_t lo, int64_t hi,
    int64_t dlo, int64_t dhi,
    // outputs
    int32_t* order_out, int64_t* counts_out, int64_t* picked_out,
    uint64_t* kh_out, int32_t* hits_out, int32_t* limit_out,
    int32_t* dur_out, int32_t* algo_out, uint8_t* gnp_out,
    uint8_t* valid_out, uint64_t* gkh_out, int32_t* glead_out,
    int32_t* gend_out, uint8_t* gvalid_out, int32_t* gid_out,
    int64_t* take_idx_out) {
  const uint64_t bmask = buckets - 1;
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;

  PrepPool& pool = PrepPool::inst();
  const int T = pool.lanes();
  const bool dbg = prep_debug();
  int64_t t0 = dbg ? now_us() : 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0;

  // phase A: per-row composite keys + per-thread shard histograms.
  // NOTE: scratch vectors are main-thread-owned; worker lambdas must
  // capture raw POINTERS — a `thread_local` referenced inside the
  // lambda body would resolve to each worker's own (empty) instance.
  static thread_local std::vector<uint64_t> key_arr_tl;
  static thread_local std::vector<int32_t> owner_arr_tl;
  key_arr_tl.resize(n);
  std::vector<std::vector<int64_t>> hist(T);
  const bool multi = n_shards > 1;
  if (multi) owner_arr_tl.resize(n);
  uint64_t* const key_arr = key_arr_tl.data();
  int32_t* const owner_arr = multi ? owner_arr_tl.data() : nullptr;
  // power-of-two shard counts (every real mesh) take a mask instead of
  // the ~30-90-cycle 64-bit modulo; both match owner_of / owner_of_np
  const bool ns_pow2 = (n_shards & (n_shards - 1)) == 0;
  const uint64_t ns_mask = (uint64_t)n_shards - 1;
  pool.run([&](int tid, int lanes) {
    hist[tid].assign(n_shards, 0);
    int64_t* const h = hist[tid].data();
    const int64_t s0 = n * tid / lanes, s1 = n * (tid + 1) / lanes;
    for (int64_t i = s0; i < s1; ++i) {
      const uint64_t kh = key_hash[i];
      const uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
      uint64_t fp = kh >> 32;
      if (fp == 0) fp = 1;
      key_arr[i] = (bkt << 32) | fp;
      if (multi) {
        const uint64_t mix = splitmix64(kh ^ SHARD_SALT);
        const int32_t o = (int32_t)(ns_pow2 ? (mix & ns_mask)
                                            : (mix % (uint64_t)n_shards));
        owner_arr[i] = o;
        ++h[o];
      } else {
        ++h[0];
      }
    }
  });

  // phase B: starts per shard + per-(shard, thread) scatter offsets
  std::vector<int64_t> starts(n_shards + 1, 0);
  std::vector<std::vector<int64_t>> off(T, std::vector<int64_t>(n_shards));
  {
    int64_t sum = 0;
    for (int64_t s = 0; s < n_shards; ++s) {
      starts[s] = sum;
      int64_t c = 0;
      for (int t = 0; t < T; ++t) {
        off[t][s] = sum + c;
        c += hist[t][s];
      }
      counts_out[s] = c;
      sum += c;
    }
    starts[n_shards] = sum;
  }

  if (dbg) t1 = now_us();
  int64_t maxc = 1;
  for (int64_t s = 0; s < n_shards; ++s)
    if (counts_out[s] > maxc) maxc = counts_out[s];
  const int64_t B = pick_rung(rungs, n_rungs, maxc);
  if (B < 0) return -1;

  // phase C: stable partition of row indices by owning shard
  static thread_local std::vector<int32_t> part_tl;
  part_tl.resize(n);
  int32_t* const part = part_tl.data();
  if (multi) {
    pool.run([&](int tid, int lanes) {
      const int64_t s0 = n * tid / lanes, s1 = n * (tid + 1) / lanes;
      int64_t* const o = off[tid].data();
      for (int64_t i = s0; i < s1; ++i) part[o[owner_arr[i]]++] = (int32_t)i;
    });
  } else {
    pool.run([&](int tid, int lanes) {
      const int64_t s0 = n * tid / lanes, s1 = n * (tid + 1) / lanes;
      for (int64_t i = s0; i < s1; ++i) part[i] = (int32_t)i;
    });
  }

  if (dbg) t2 = now_us();
  // phase D part 1: per-shard stable radix argsort (order_out) + group
  // counts (gcounts). G rung selection needs every shard's group count,
  // so the fused output walk is a second parallel phase.
  std::vector<int64_t> gcounts(n_shards, 0), gstarts(n_shards + 1, 0);
  // leader positions (shard-local j) found by the sort pass, consumed by
  // the marshal pass: at most one leader per row
  static thread_local std::vector<int32_t> lead_tl;
  lead_tl.resize(n);
  int32_t* const lead_scratch = lead_tl.data();
  // 12-bit digits over the BUCKET bits only (fp handled by per-run
  // fixups): ceil(15/12) = 2 passes at the default 32k-bucket store,
  // histogram small enough that the per-pass memset (32 KiB) is noise
  constexpr int DIGIT = 12;
  constexpr int64_t DMASK = (1 << DIGIT) - 1;
  const int passes = (bucket_bits + DIGIT - 1) / DIGIT;
  std::atomic<int64_t> next_shard{0};
  pool.run([&](int, int) {
    // (key, idx) pair radix: keys stream sequentially each pass and the
    // scatter partitions stay cache-resident (vs random key_arr[a[j]]
    // loads every pass in an index-only sort)
    static thread_local std::vector<uint64_t> ka, kb;
    static thread_local std::vector<int32_t> ia, ib;
    static thread_local std::vector<int64_t> h(1 << DIGIT);
    for (;;) {
      const int64_t s = next_shard.fetch_add(1);
      if (s >= n_shards) break;
      const int64_t cnt = counts_out[s], st = starts[s];
      if (cnt == 0) continue;
      ka.resize(cnt);
      kb.resize(cnt);
      ia.resize(cnt);
      ib.resize(cnt);
      for (int64_t j = 0; j < cnt; ++j) {
        const int32_t row = part[st + j];
        ia[j] = row;
        ka[j] = key_arr[row];
      }
      // radix ONLY the bucket bits (>= 32): full-fp passes would be
      // wasted work — fingerprint order matters only WITHIN a bucket
      // run, and at serving load factors (~1 key/bucket) almost every
      // run is a singleton or a single hot key's duplicates. The rare
      // multi-fp run gets a stable_sort fixup below. Halves the passes
      // at the default 15-bucket-bit store (2 vs 4).
      if (passes > 1 && cnt >= (int64_t)(buckets >> 2) &&
          bucket_bits <= 18) {
        // dense slice (single-device path: cnt == n vs 32k buckets):
        // ONE counting pass over the whole bucket space beats two
        // 12-bit passes — the histogram walk amortizes over enough rows
        static thread_local std::vector<int64_t> hb;
        hb.assign((size_t)buckets, 0);
        for (int64_t j = 0; j < cnt; ++j) ++hb[ka[j] >> 32];
        int64_t sum = 0;
        for (uint64_t d = 0; d < buckets; ++d) {
          const int64_t c = hb[d];
          hb[d] = sum;
          sum += c;
        }
        for (int64_t j = 0; j < cnt; ++j) {
          const int64_t pos = hb[ka[j] >> 32]++;
          kb[pos] = ka[j];
          ib[pos] = ia[j];
        }
        ka.swap(kb);
        ia.swap(ib);
      } else {
        for (int p = 0; p < passes; ++p) {
          const int shift = 32 + p * DIGIT;
          std::memset(h.data(), 0, h.size() * sizeof(int64_t));
          const uint32_t first = (ka[0] >> shift) & DMASK;
          bool uniform = true;
          for (int64_t j = 0; j < cnt; ++j) {
            const uint32_t d = (ka[j] >> shift) & DMASK;
            ++h[d];
            uniform &= (d == first);
          }
          if (uniform) continue;  // pass is a no-op permutation
          int64_t sum = 0;
          for (int64_t d = 0; d <= DMASK; ++d) {
            const int64_t c = h[d];
            h[d] = sum;
            sum += c;
          }
          for (int64_t j = 0; j < cnt; ++j) {
            const int64_t pos = h[(ka[j] >> shift) & DMASK]++;
            kb[pos] = ka[j];
            ib[pos] = ia[j];
          }
          ka.swap(kb);
          ia.swap(ib);
        }
      }
      // fixups + leaders in one walk: for each bucket run, if the fps
      // are not already non-decreasing, stable_sort the (key, idx)
      // pairs by full key (fp in the low bits; stability keeps input
      // order on ties). Leaders are full-key change positions.
      int32_t* ls = lead_scratch + st;
      int64_t g = 0;
      int64_t rs = 0;  // bucket-run start
      for (int64_t j = 0; j <= cnt; ++j) {
        const bool run_end =
            (j == cnt) || ((ka[j] >> 32) != (ka[rs] >> 32));
        if (!run_end) continue;
        if (j - rs > 1) {
          bool sorted = true;
          for (int64_t q = rs + 1; q < j; ++q)
            if (ka[q] < ka[q - 1]) {
              sorted = false;
              break;
            }
          if (!sorted) {
            // sort pairs by key, input-stable: indices ride along
            static thread_local std::vector<std::pair<uint64_t, int32_t>>
                tmp;
            tmp.resize(j - rs);
            for (int64_t q = rs; q < j; ++q)
              tmp[q - rs] = {ka[q], ia[q]};
            std::stable_sort(
                tmp.begin(), tmp.end(),
                [](const auto& x, const auto& y) {
                  return x.first < y.first;
                });
            for (int64_t q = rs; q < j; ++q) {
              ka[q] = tmp[q - rs].first;
              ia[q] = tmp[q - rs].second;
            }
          }
        }
        for (int64_t q = rs; q < j; ++q)
          if (q == rs || ka[q] != ka[q - 1]) ls[g++] = (int32_t)q;
        if (j < cnt) rs = j;
      }
      gcounts[s] = g;
      std::memcpy(order_out + st, ia.data(), cnt * sizeof(int32_t));
    }
  });

  if (dbg) t3 = now_us();
  int64_t maxg = 1;
  for (int64_t s = 0; s < n_shards; ++s) {
    gstarts[s + 1] = gstarts[s] + gcounts[s];
    if (gcounts[s] > maxg) maxg = gcounts[s];
  }
  int64_t G;
  if (g_override > 0) {
    if (g_override < maxg) return -2;
    G = g_override;
  } else {
    int64_t gr[4];
    const int ng = group_rungs_c(B, gr);
    G = pick_rung(gr, ng, maxg);
    if (G < 0) return -1;  // unreachable: top rung is B >= maxc >= maxg
  }
  picked_out[0] = B;
  picked_out[1] = G;

  // phase D part 2: per-shard marshal — one streaming loop PER FIELD
  // (interleaved 8-array writes per row defeat vectorization; per-field
  // loops make the padding tail a vectorized constant fill and the real
  // rows a single gather+store stream), then groups from the sort
  // pass's leader scratch with build_groups' padding conventions.
  std::atomic<int64_t> next_shard2{0};
  pool.run([&](int, int) {
    for (;;) {
      const int64_t s = next_shard2.fetch_add(1);
      if (s >= n_shards) break;
      const int64_t cnt = counts_out[s], st = starts[s];
      if (cnt == 0) continue;  // filled by the serial fixup below —
      // the fill row belongs to another shard whose order may not be
      // written yet
      const int32_t* ord = order_out + st;
      uint64_t* kh_o = kh_out + s * B;
      int32_t* hi_o = hits_out + s * B;
      int32_t* li_o = limit_out + s * B;
      int32_t* du_o = dur_out + s * B;
      int32_t* al_o = algo_out + s * B;
      uint8_t* gn_o = gnp_out + s * B;
      uint8_t* va_o = valid_out + s * B;
      int32_t* gi_o = gid_out + s * B;
      uint64_t* gk_o = gkh_out + s * G;
      int32_t* gl_o = glead_out + s * G;
      int32_t* ge_o = gend_out + s * G;
      uint8_t* gv_o = gvalid_out + s * G;

      for (int64_t j = 0; j < cnt; ++j) kh_o[j] = key_hash[ord[j]];
      std::fill(kh_o + cnt, kh_o + B, kh_o[cnt - 1]);
      for (int64_t j = 0; j < cnt; ++j)
        hi_o[j] = clip_i64(hits[ord[j]], lo, hi);
      std::fill(hi_o + cnt, hi_o + B, hi_o[cnt - 1]);
      for (int64_t j = 0; j < cnt; ++j)
        li_o[j] = clip_i64(limit[ord[j]], lo, hi);
      std::fill(li_o + cnt, li_o + B, li_o[cnt - 1]);
      for (int64_t j = 0; j < cnt; ++j)
        du_o[j] = clip_i64(duration[ord[j]], dlo, dhi);
      std::fill(du_o + cnt, du_o + B, du_o[cnt - 1]);
      for (int64_t j = 0; j < cnt; ++j) al_o[j] = algo[ord[j]];
      std::fill(al_o + cnt, al_o + B, al_o[cnt - 1]);
      for (int64_t j = 0; j < cnt; ++j) gn_o[j] = gnp[ord[j]];
      std::fill(gn_o + cnt, gn_o + B, gn_o[cnt - 1]);
      std::memset(va_o, 1, cnt);
      std::memset(va_o + cnt, 0, B - cnt);
      int64_t* tk = take_idx_out + st;
      const int64_t base = s * B;
      for (int64_t j = 0; j < cnt; ++j) tk[j] = base + j;

      // groups: leaders from the sort pass; run fills are sequential
      const int32_t* ls = lead_scratch + st;
      const int64_t gc = gcounts[s];
      for (int64_t g = 0; g < gc; ++g) {
        const int64_t lead = ls[g];
        const int64_t next = (g + 1 < gc) ? ls[g + 1] : cnt;
        gl_o[g] = (int32_t)lead;
        ge_o[g] = (int32_t)((g + 1 < gc) ? next - 1 : B - 1);
        gk_o[g] = kh_o[lead];
        gv_o[g] = 1;
        for (int64_t j = lead; j < next; ++j) gi_o[j] = (int32_t)g;
      }
      std::fill(gi_o + cnt, gi_o + B, (int32_t)(gc - 1));
      // padded group slots: leader=B, end=B-1, invalid, key of row B-1
      std::fill(gl_o + gc, gl_o + G, (int32_t)B);
      std::fill(ge_o + gc, ge_o + G, (int32_t)(B - 1));
      std::memset(gv_o + gc, 0, G - gc);
      std::fill(gk_o + gc, gk_o + G, kh_o[B - 1]);
    }
  });

  if (dbg) t4 = now_us();
  // serial fixup for empty shards: numpy twin semantics — padded cells
  // replicate order[clip(starts[s], 0, n-1)] (the next shard's first
  // sorted row), group ids 0, group keys kh_padded[B-1].
  for (int64_t s = 0; s < n_shards; ++s) {
    if (counts_out[s] != 0) continue;
    const int64_t src = starts[s] < n ? starts[s] : (n > 0 ? n - 1 : 0);
    const int32_t row = n > 0 ? order_out[src] : 0;
    const uint64_t kf = n > 0 ? key_hash[row] : 0;
    const int32_t hf = n > 0 ? clip_i64(hits[row], lo, hi) : 0;
    const int32_t lf = n > 0 ? clip_i64(limit[row], lo, hi) : 0;
    const int32_t df = n > 0 ? clip_i64(duration[row], dlo, dhi) : 0;
    const int32_t af = n > 0 ? algo[row] : 0;
    const uint8_t gf = n > 0 ? gnp[row] : 0;
    uint64_t* kh_o = kh_out + s * B;
    int32_t* hi_o = hits_out + s * B;
    int32_t* li_o = limit_out + s * B;
    int32_t* du_o = dur_out + s * B;
    int32_t* al_o = algo_out + s * B;
    uint8_t* gn_o = gnp_out + s * B;
    uint8_t* va_o = valid_out + s * B;
    int32_t* gi_o = gid_out + s * B;
    for (int64_t j = 0; j < B; ++j) {
      kh_o[j] = kf;
      hi_o[j] = hf;
      li_o[j] = lf;
      du_o[j] = df;
      al_o[j] = af;
      gn_o[j] = gf;
      va_o[j] = 0;
      gi_o[j] = 0;
    }
    uint64_t* gk_o = gkh_out + s * G;
    int32_t* gl_o = glead_out + s * G;
    int32_t* ge_o = gend_out + s * G;
    uint8_t* gv_o = gvalid_out + s * G;
    for (int64_t q = 0; q < G; ++q) {
      gk_o[q] = kf;
      gl_o[q] = (int32_t)B;
      ge_o[q] = (int32_t)(B - 1);
      gv_o[q] = 0;
    }
  }
  if (dbg) {
    const int64_t t5 = now_us();
    fprintf(stderr,
            "prep phases us: A+B=%ld C=%ld sort=%ld marshal=%ld fixup=%ld "
            "total=%ld (T=%d)\n",
            (long)(t1 - t0), (long)(t2 - t1), (long)(t3 - t2),
            (long)(t4 - t3), (long)(t5 - t4), (long)(t5 - t0), T);
  }
  return 0;
}

// Mesh response unflatten: out[c][order[st+j]] = packed[s][c*B_sub + j]
// for the n real rows — the native twin of MeshEngine.decide_arrays's
// per-column `out[order] = flat[take_idx]`, all four response columns in
// one pass. packed rows have `stride` int32s (4*B_sub + stats tail).
void guber_unflatten_resp(const int32_t* packed, const int32_t* order,
                          const int64_t* counts, int64_t n,
                          int64_t n_shards, int64_t b_sub, int64_t stride,
                          int32_t* out) {
  int64_t st = 0;
  for (int64_t s = 0; s < n_shards; ++s) {
    const int64_t cnt = counts[s];
    const int32_t* row = packed + s * stride;
    for (int64_t c = 0; c < 4; ++c) {
      const int32_t* col = row + c * b_sub;
      int32_t* o = out + c * n;
      for (int64_t j = 0; j < cnt; ++j) o[order[st + j]] = col[j];
    }
    st += cnt;
  }
}

// Sorted-run merge combine (r9): stable k-way merge of per-group
// PRE-SORTED runs (serve/batcher.py arrival-time prep), fused with the
// field materialization + request padding the flush path needs — one
// GIL-free pass replacing the flattened batch's concat + full radix
// sort + marshal. Stability contract (pinned python-side): equal sort
// keys resolve in run order, and runs arrive in caller order, so the
// merged permutation equals np.argsort(concat, kind="stable").
//
// Inputs are k parallel pointer tables (one entry per run) of the
// sorted skey / device-dtype fields / within-run caller order, plus
// per-run lengths ns[k] and flattened-batch base offsets bases[k].
// Outputs: merged skey[n] (group derivation + mesh slicing),
// order_out[B] (global caller index; tail = identity, the engine's
// padding convention), the six padded field arrays [B] (tail repeats
// the last merged row, valid=0 — pad_request_sorted's convention), and
// the duplicate-key group stream (group_id[n], leader_pos[n], g_real).
// Pass B == n to skip padding (the mesh path lays out per-shard
// sub-batches from the flat merged stream instead).
// When n_rungs > 0, the group stream is additionally PADDED to the
// smallest rung G >= max(g_real, 1) of g_rungs (engine.group_rungs'
// ladder, engine.build_groups' conventions): gkh/glead/gend/gvalid
// sized G (caller allocates g_rungs[n_rungs-1]), group_id_out sized B
// with the padding tail pointing at the last real group, and the
// picked G returned through g_pick_out — so the whole merge + pad +
// group build is one GIL-free call. n_rungs == 0 skips the padding
// (the mesh path lays out per-shard groups itself).
int64_t guber_merge_runs(
    const uint64_t* const* skeys, const uint64_t* const* khs,
    const int32_t* const* hits, const int32_t* const* limits,
    const int32_t* const* durs, const int32_t* const* algos,
    const uint8_t* const* gnps, const int32_t* const* orders,
    const int64_t* ns, const int64_t* bases, int64_t k, int64_t B,
    const int64_t* g_rungs, int64_t n_rungs, uint64_t* skey_out,
    int32_t* order_out, uint64_t* kh_out, int32_t* hits_out,
    int32_t* limit_out, int32_t* dur_out, int32_t* algo_out,
    uint8_t* gnp_out, uint8_t* valid_out, int32_t* group_id_out,
    int32_t* leader_pos_out, uint64_t* gkh_out, int32_t* gend_out,
    uint8_t* gvalid_out, int64_t* g_real_out, int64_t* g_pick_out) {
  int64_t n = 0;
  for (int64_t r = 0; r < k; ++r) n += ns[r];
  if (n > B) return -1;
  // binary min-heap of run heads ordered by (key, run index): the run
  // tie-break is what keeps equal keys in caller order (runs are
  // caller-ordered), matching a stable sort of the concatenation
  struct Head {
    uint64_t key;
    int64_t run;
  };
  std::vector<Head> heap;
  heap.reserve((size_t)k);
  std::vector<int64_t> pos((size_t)k, 0);
  auto lt = [](const Head& a, const Head& b) {
    return a.key < b.key || (a.key == b.key && a.run < b.run);
  };
  auto sift_down = [&](size_t i) {
    const size_t sz = heap.size();
    for (;;) {
      size_t s = i, l = 2 * i + 1, r2 = 2 * i + 2;
      if (l < sz && lt(heap[l], heap[s])) s = l;
      if (r2 < sz && lt(heap[r2], heap[s])) s = r2;
      if (s == i) return;
      std::swap(heap[i], heap[s]);
      i = s;
    }
  };
  for (int64_t r = 0; r < k; ++r)
    if (ns[r] > 0) heap.push_back({skeys[r][0], r});
  for (size_t i = heap.size(); i-- > 0;) sift_down(i);

  int64_t g = -1;
  uint64_t prev_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = heap[0].run;
    const int64_t j = pos[(size_t)r]++;
    const uint64_t key = heap[0].key;
    skey_out[i] = key;
    order_out[i] = (int32_t)(orders[r][j] + bases[r]);
    kh_out[i] = khs[r][j];
    hits_out[i] = hits[r][j];
    limit_out[i] = limits[r][j];
    dur_out[i] = durs[r][j];
    algo_out[i] = algos[r][j];
    gnp_out[i] = gnps[r][j];
    valid_out[i] = 1;
    if (i == 0 || key != prev_key) {
      leader_pos_out[++g] = (int32_t)i;
      prev_key = key;
    }
    group_id_out[i] = (int32_t)g;
    if (j + 1 < ns[r]) {
      heap[0].key = skeys[r][j + 1];
    } else {
      heap[0] = heap.back();
      heap.pop_back();
    }
    if (!heap.empty()) sift_down(0);
  }
  const int64_t g_real = g + 1;
  *g_real_out = g_real;
  // padding tail: repeat the last merged row with valid=0; order maps
  // padding rows to themselves (engine padding conventions)
  // (see guber_prep_run below for the arrival-side producer)
  for (int64_t i = n; i < B; ++i) {
    order_out[i] = (int32_t)i;
    kh_out[i] = n ? kh_out[n - 1] : 0;
    hits_out[i] = n ? hits_out[n - 1] : 0;
    limit_out[i] = n ? limit_out[n - 1] : 0;
    dur_out[i] = n ? dur_out[n - 1] : 0;
    algo_out[i] = n ? algo_out[n - 1] : 0;
    gnp_out[i] = n ? gnp_out[n - 1] : 0;
    valid_out[i] = 0;
  }
  if (n_rungs > 0) {
    // padded group build, engine.build_groups conventions: pick the
    // smallest rung holding the real groups, real slots get
    // leader/end/key, the final real group owns the request padding
    // tail, padded slots carry leader=B / end=B-1 / valid=0, and
    // padded request rows point at the last real group
    const int64_t g_need = g_real > 1 ? g_real : 1;
    int64_t G = 0;
    for (int64_t r = 0; r < n_rungs; ++r) {
      if (g_rungs[r] >= g_need) {
        G = g_rungs[r];
        break;
      }
    }
    if (G == 0) return -3;  // ladder cannot hold the group count
    *g_pick_out = G;
    for (int64_t q = 0; q < g_real; ++q) {
      const int32_t lead = leader_pos_out[q];
      gkh_out[q] = kh_out[lead];
      gend_out[q] =
          q + 1 < g_real ? leader_pos_out[q + 1] - 1 : (int32_t)(B - 1);
      gvalid_out[q] = 1;
    }
    const uint64_t k_pad = B ? kh_out[B - 1] : 0;
    for (int64_t q = g_real; q < G; ++q) {
      leader_pos_out[q] = (int32_t)B;
      gkh_out[q] = k_pad;
      gend_out[q] = (int32_t)(B - 1);
      gvalid_out[q] = 0;
    }
    const int32_t gid_pad = (int32_t)(g_real > 0 ? g_real - 1 : 0);
    for (int64_t i = n; i < B; ++i) group_id_out[i] = gid_pad;
  }
  return 0;
}

// Arrival-time per-group prep (r9): ONE call fusing the sharded
// presort (guber_presort_sharded), the device-dtype clip+gather of all
// six request fields, and the composite sort-key stream the merge
// orders by — the producer side of guber_merge_runs. One GIL-free
// call per enqueued group keeps the prep pool's threads off the
// interpreter while the serving loop is hot. n_shards == 1 degrades
// to the single-device (bucket, fingerprint) order: the owner bits
// are zero, so the composite key equals group_sort_key_np's.
int64_t guber_prep_run(const uint64_t* key_hash, const int64_t* hits,
                       const int64_t* limits, const int64_t* durs,
                       const int32_t* algos, const uint8_t* gnps,
                       int64_t n, uint64_t buckets, int64_t n_shards,
                       int64_t lo, int64_t hi, int64_t dlo, int64_t dhi,
                       int32_t* order_out, int64_t* counts_out,
                       uint64_t* skey_out, uint64_t* kh_out,
                       int32_t* hits_out, int32_t* limit_out,
                       int32_t* dur_out, int32_t* algo_out,
                       uint8_t* gnp_out) {
  guber_presort_sharded(key_hash, n, buckets, (uint64_t)n_shards,
                        order_out, counts_out);
  int bucket_bits = 0;
  while ((1ULL << bucket_bits) < buckets) ++bucket_bits;
  if (bucket_bits < 1) bucket_bits = 1;  // python max(bit_length-1, 1)
  const uint64_t bmask = buckets - 1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t j = order_out[i];
    const uint64_t kh = key_hash[j];
    kh_out[i] = kh;
    uint64_t owner =
        n_shards > 1 ? splitmix64(kh ^ SHARD_SALT) % (uint64_t)n_shards
                     : 0;
    const uint64_t bkt = splitmix64(kh ^ BUCKET_SALT) & bmask;
    uint64_t fp = kh >> 32;
    if (fp == 0) fp = 1;
    skey_out[i] = (owner << (32 + bucket_bits)) | (bkt << 32) | fp;
    int64_t h = hits[j];
    hits_out[i] = (int32_t)(h < lo ? lo : (h > hi ? hi : h));
    int64_t l = limits[j];
    limit_out[i] = (int32_t)(l < lo ? lo : (l > hi ? hi : l));
    int64_t d = durs[j];
    dur_out[i] = (int32_t)(d < dlo ? dlo : (d > dhi ? dhi : d));
    algo_out[i] = algos[j];
    gnp_out[i] = gnps[j];
  }
  return 0;
}

}  // extern "C"
