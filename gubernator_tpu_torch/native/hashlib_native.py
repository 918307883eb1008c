"""ctypes bindings for libguberhash.so (see guberhash.cc): the port's
copy of gubernator_tpu/native/hashlib_native.py.

Only the loading differs: importing this module builds guberhash.cc with
g++ into `gubernator_tpu_torch/_build/` at first use
(native/edge_build.build_hasher) and loads the library from there. A
failed build or load raises ImportError carrying the compiler's output;
core/hashing.py logs it and falls back to blake2b-8. Imports ctypes and
numpy only, never torch: the torch-free GEB client (client_geb.py)
hashes with it.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from typing import List

import numpy as np

from gubernator_tpu_torch.native import edge_build

try:
    _SO = edge_build.build_hasher()
    _lib = ctypes.CDLL(str(_SO))
except (RuntimeError, OSError, subprocess.SubprocessError) as e:
    raise ImportError(f"native hash library not built or not loadable: {e}") from e
_lib.guber_hash_batch.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
    ctypes.c_uint64,
    ctypes.POINTER(ctypes.c_uint64),
]
_lib.guber_crc32_batch.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint32),
]
try:  # symbol absent in a stale prebuilt .so — the hash/crc fast paths
    # above must keep working regardless; presort() raises if missing
    _lib.guber_presort.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _HAS_PRESORT = True
except AttributeError:
    _HAS_PRESORT = False

try:
    _i32p = ctypes.POINTER(ctypes.c_int32)
    _lib.guber_gather_pad_i64_clip.argtypes = [
        ctypes.POINTER(ctypes.c_int64), _i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p,
    ]
    _lib.guber_gather_pad_i32.argtypes = [
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int64, _i32p,
    ]
    _lib.guber_gather_pad_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), _i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
    ]
    _lib.guber_gather_pad_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), _i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib.guber_unpermute_i32.argtypes = [
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i32p,
    ]
    _HAS_MARSHAL = True
except AttributeError:
    _HAS_MARSHAL = False


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gather_pad_i64_clip(src, order, b: int, lo: int, hi: int) -> np.ndarray:
    """int32[b] = clip(src[order], lo, hi) padded with its last value."""
    src = np.ascontiguousarray(src, np.int64)
    out = np.empty(b, np.int32)
    _lib.guber_gather_pad_i64_clip(
        _ptr(src, ctypes.c_int64), _ptr(order, ctypes.c_int32),
        src.shape[0], b, lo, hi, _ptr(out, ctypes.c_int32),
    )
    return out


def gather_pad_i32(src, order, b: int) -> np.ndarray:
    src = np.ascontiguousarray(src, np.int32)
    out = np.empty(b, np.int32)
    _lib.guber_gather_pad_i32(
        _ptr(src, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        src.shape[0], b, _ptr(out, ctypes.c_int32),
    )
    return out


def gather_pad_u64(src, order, b: int) -> np.ndarray:
    src = np.ascontiguousarray(src, np.uint64)
    out = np.empty(b, np.uint64)
    _lib.guber_gather_pad_u64(
        _ptr(src, ctypes.c_uint64), _ptr(order, ctypes.c_int32),
        src.shape[0], b, _ptr(out, ctypes.c_uint64),
    )
    return out


def gather_pad_u8(src, order, b: int) -> np.ndarray:
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty(b, np.uint8)
    _lib.guber_gather_pad_u8(
        _ptr(src, ctypes.c_uint8), _ptr(order, ctypes.c_int32),
        src.shape[0], b, _ptr(out, ctypes.c_uint8),
    )
    return out


def unpermute_i32(sorted_stack: np.ndarray, order: np.ndarray,
                  n: int) -> np.ndarray:
    """[k, b] row-major response stack -> out[:, order[:n]] scatter:
    out[a, order[i]] = sorted[a, i] for i < n (padding rows untouched)."""
    sorted_stack = np.ascontiguousarray(sorted_stack, np.int32)
    k, b = sorted_stack.shape
    out = np.empty((k, b), np.int32)
    _lib.guber_unpermute_i32(
        _ptr(sorted_stack, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        n, b, k, _ptr(out, ctypes.c_int32),
    )
    return out


try:
    _lib.guber_presort_grouped.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _HAS_PRESORT_GROUPED = True
except AttributeError:
    _HAS_PRESORT_GROUPED = False


def presort_grouped(key_hash: np.ndarray, buckets: int):
    """(order int32[n], group_id int32[n], leader_pos int32[n], G) —
    the presort permutation plus the duplicate-key group structure of
    the sorted stream (only leader_pos[:G] is meaningful)."""
    if not _HAS_PRESORT_GROUPED:
        raise AttributeError(
            "libguberhash.so predates guber_presort_grouped; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(key_hash, np.uint64)
    n = kh.shape[0]
    order = np.empty(n, np.int32)
    group_id = np.empty(n, np.int32)
    leader_pos = np.empty(n, np.int32)
    G = ctypes.c_int64(0)
    _lib.guber_presort_grouped(
        _ptr(kh, ctypes.c_uint64), n, ctypes.c_uint64(buckets),
        _ptr(order, ctypes.c_int32), _ptr(group_id, ctypes.c_int32),
        _ptr(leader_pos, ctypes.c_int32), ctypes.byref(G),
    )
    return order, group_id, leader_pos, G.value


try:
    _lib.guber_presort_sharded.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _HAS_PRESORT_SHARDED = True
except AttributeError:
    _HAS_PRESORT_SHARDED = False

# Fixed seed: slot hashes are instance-local but stable across restarts for
# debuggability.
_SEED = 0x67756265726E6174  # "gubernat"


def _pack(keys: List[str]):
    bufs = [k.encode("utf-8") for k in keys]
    offsets = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return b"".join(bufs), offsets


def hash_batch_seed(keys: List[str], seed: int) -> np.ndarray:
    """uint64[len(keys)] XXH64 hashes with an explicit seed (test hook)."""
    buf, offsets = _pack(keys)
    out = np.empty(len(keys), np.uint64)
    _lib.guber_hash_batch(
        buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def hash_batch(keys: List[str]) -> np.ndarray:
    """uint64[len(keys)] XXH64 slot hashes."""
    return hash_batch_seed(keys, _SEED)


def crc32_batch(keys: List[str]) -> np.ndarray:
    """uint32[len(keys)] IEEE crc32 ring points (matches zlib.crc32)."""
    buf, offsets = _pack(keys)
    out = np.empty(len(keys), np.uint32)
    _lib.guber_crc32_batch(
        buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def presort(key_hash: np.ndarray, buckets: int) -> np.ndarray:
    """int32[n] stable argsort of key hashes by (bucket, fingerprint) —
    the order decide_presorted requires. Bit-identical to
    np.argsort(store.group_sort_key_np(kh, buckets), kind="stable") and
    ~15x faster (LSD radix in C)."""
    if not _HAS_PRESORT:
        raise AttributeError(
            "libguberhash.so predates guber_presort; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(key_hash, np.uint64)
    out = np.empty(kh.shape[0], np.int32)
    _lib.guber_presort(
        kh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        kh.shape[0],
        ctypes.c_uint64(buckets),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


try:
    _lib.guber_presort_sharded_grouped.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _HAS_PRESORT_SHARDED_GROUPED = True
except AttributeError:
    _HAS_PRESORT_SHARDED_GROUPED = False


def presort_sharded_grouped(key_hash: np.ndarray, buckets: int,
                            n_shards: int):
    """(order, counts, group_id, leader_pos, group_counts) — the sharded
    presort plus per-shard duplicate-key group structure. group_id[i] is
    the GLOBAL group index of sorted row i; leader_pos[:sum(group_counts)]
    holds each global group's first sorted row; group_counts[s] counts
    shard s's groups."""
    if not _HAS_PRESORT_SHARDED_GROUPED:
        raise AttributeError(
            "libguberhash.so predates guber_presort_sharded_grouped; "
            "rebuild with gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(key_hash, np.uint64)
    n = kh.shape[0]
    order = np.empty(n, np.int32)
    counts = np.empty(n_shards, np.int64)
    group_id = np.empty(n, np.int32)
    leader_pos = np.empty(n, np.int32)
    group_counts = np.empty(n_shards, np.int64)
    _lib.guber_presort_sharded_grouped(
        _ptr(kh, ctypes.c_uint64), n, ctypes.c_uint64(buckets),
        ctypes.c_uint64(n_shards), _ptr(order, ctypes.c_int32),
        _ptr(counts, ctypes.c_int64), _ptr(group_id, ctypes.c_int32),
        _ptr(leader_pos, ctypes.c_int32),
        _ptr(group_counts, ctypes.c_int64),
    )
    return order, counts, group_id, leader_pos, group_counts


def presort_sharded(key_hash: np.ndarray, buckets: int, n_shards: int):
    """(order int32[n], counts int64[n_shards]) — stable argsort by
    (owner_shard, bucket, fingerprint) plus per-shard row counts. The
    contiguous per-shard runs of the permutation are the mesh engine's
    per-chip sub-batches (parallel/sharded.py pad_request_sharded)."""
    if not _HAS_PRESORT_SHARDED:
        raise AttributeError(
            "libguberhash.so predates guber_presort_sharded; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(key_hash, np.uint64)
    order = np.empty(kh.shape[0], np.int32)
    counts = np.empty(n_shards, np.int64)
    _lib.guber_presort_sharded(
        kh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        kh.shape[0],
        ctypes.c_uint64(buckets),
        ctypes.c_uint64(n_shards),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order, counts


try:
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    _i64p = ctypes.POINTER(ctypes.c_int64)
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib.guber_prep_sharded.restype = ctypes.c_int64
    _lib.guber_prep_sharded.argtypes = [
        _u64p, _i64p, _i64p, _i64p, _i32p, _u8p,          # inputs
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,  # n, buckets, ns
        _i64p, ctypes.c_int64, ctypes.c_int64,            # rungs, n_rungs, g_override
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # clips
        _i32p, _i64p, _i64p,                              # order, counts, picked
        _u64p, _i32p, _i32p, _i32p, _i32p, _u8p, _u8p,    # fields
        _u64p, _i32p, _i32p, _u8p, _i32p,                 # groups
        _i64p,                                            # take_idx
    ]
    _lib.guber_prep_threads.restype = ctypes.c_int64
    _lib.guber_unflatten_resp.argtypes = [
        _i32p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i32p,
    ]
    _HAS_PREP = True
except AttributeError:
    _HAS_PREP = False


def prep_threads() -> int:
    """Effective prep thread-pool width (GUBER_PREP_THREADS env,
    default hardware_concurrency; resolved once per process)."""
    if not _HAS_PREP:
        return 1
    return int(_lib.guber_prep_threads())


_PREP_GENS = 2


def set_prep_generations(gens: int) -> None:
    """Size the prep-buffer ring (serve/batcher.py's fetch_depth sets
    gens = depth + 1 at construction, before traffic). Generation k is
    reused at the k+gens'th prep call on the same thread.

    NOTE the ring is NOT what guarantees in-flight correctness under the
    batcher's out-of-order fetch pipeline — no fixed depth could (a
    stalled fetch can be outrun by later submits without bound). The
    guarantees are: (a) decide handles keep no view of the ring
    (parallel/sharded.py TorchEngine.decide_submit), and (b) the
    engine's upload copies host inputs before submit returns (a
    blocking copy on the card; on the CPU the decide itself runs before
    submit returns). The deeper ring is defense in depth. Threads pick
    the new width up on their next prep call."""
    global _PREP_GENS
    _PREP_GENS = max(2, int(gens))


class _PrepBuffers:
    """Reusable output buffers for prep_sharded, rotated across calls.
    Fresh np.empty per call costs ~0.5-1ms of soft page faults at
    32k batches (every large allocation is a new zeroed mmap); reusing
    warm pages removes that entirely. The ring holds _PREP_GENS
    generations (default two: at most two batches in flight, submits
    serialized — serve/batcher.py) so a pipelined engine never sees
    generation k's arrays overwritten before its wait."""

    _SPECS = (
        ("order", np.int32), ("counts", np.int64), ("take", np.int64),
        ("kh", np.uint64), ("hits", np.int32), ("limit", np.int32),
        ("dur", np.int32), ("algo", np.int32), ("gnp", np.uint8),
        ("valid", np.uint8), ("gid", np.int32), ("gkh", np.uint64),
        ("glead", np.int32), ("gend", np.int32), ("gvalid", np.uint8),
    )

    def __init__(self):
        self._gens: list = []
        self._flip = 0

    def take(self, sizes: dict) -> dict:
        if len(self._gens) != _PREP_GENS:
            # ring width changed (set_prep_generations) or first use
            self._gens = [{} for _ in range(_PREP_GENS)]
            self._flip = 0
        gen = self._gens[self._flip]
        self._flip = (self._flip + 1) % len(self._gens)
        out = {}
        for name, dtype in self._SPECS:
            need = sizes[name]
            cur = gen.get(name)
            if cur is None or cur.shape[0] < need:
                cur = np.empty(need, dtype)
                gen[name] = cur
            out[name] = cur
        return out


class _PrepBuffersTL(threading.local):
    """Per-thread buffer sets: K concurrent prep workers (the batcher's
    prep pool) each flip-flop their own generations, so one worker's
    in-flight batch is never overwritten by another's call."""

    def __init__(self):
        self.bufs = _PrepBuffers()


_prep_buffers_tl = _PrepBuffersTL()


def prep_sharded(
    key_hash, hits, limit, duration, algo, gnp,
    buckets: int, n_shards: int, rungs, g_override: int,
    lo: int, hi: int, dlo: int, dhi: int,
):
    """One-call sharded batch prep (guber_prep_sharded): presort by
    (owner, bucket, fingerprint), duplicate-key group structure with
    engine.build_groups conventions, and all six clipped+padded device
    fields as [n_shards, B_sub] arrays. Returns
    (order, counts, take_idx, fields_dict, groups_dict, B_sub, G_sub).
    Raises ValueError when g_override can't hold a shard's group count
    (mirrors pad_request_sharded's numpy path).

    LIFETIME: returned arrays are views into a reusable buffer ring —
    valid until the _PREP_GENS'th next prep_sharded call on the same
    thread (default 2; see set_prep_generations). Callers keeping
    results past that — e.g. decide handles under a deep fetch
    pipeline — must copy."""
    if not _HAS_PREP:
        raise AttributeError(
            "libguberhash.so predates guber_prep_sharded; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(key_hash, np.uint64)
    hits = np.ascontiguousarray(hits, np.int64)
    limit = np.ascontiguousarray(limit, np.int64)
    duration = np.ascontiguousarray(duration, np.int64)
    algo = np.ascontiguousarray(algo, np.int32)
    gnp = np.ascontiguousarray(np.asarray(gnp, bool).view(np.uint8))
    n = kh.shape[0]
    rungs = np.ascontiguousarray(rungs, np.int64)
    # B_sub <= smallest rung covering n (shard counts never exceed n)
    alloc_idx = int(np.searchsorted(rungs, min(n, int(rungs[-1]))))
    B_alloc = int(rungs[min(alloc_idx, rungs.shape[0] - 1)])
    if g_override > 0:
        B_alloc = max(B_alloc, int(g_override))

    nb = n_shards * B_alloc
    buf = _prep_buffers_tl.bufs.take(dict(
        order=n, counts=n_shards, take=n,
        kh=nb, hits=nb, limit=nb, dur=nb, algo=nb, gnp=nb, valid=nb,
        gid=nb, gkh=nb, glead=nb, gend=nb, gvalid=nb,
    ))
    order = buf["order"][:n]
    counts = buf["counts"][:n_shards]
    picked = np.empty(2, np.int64)
    take_idx = buf["take"][:n]
    kh_o, hi_o, li_o, du_o = buf["kh"], buf["hits"], buf["limit"], buf["dur"]
    al_o, gn_o, va_o, gi_o = buf["algo"], buf["gnp"], buf["valid"], buf["gid"]
    gk_o, gl_o, ge_o, gv_o = buf["gkh"], buf["glead"], buf["gend"], buf["gvalid"]

    rc = _lib.guber_prep_sharded(
        _ptr(kh, ctypes.c_uint64), _ptr(hits, ctypes.c_int64),
        _ptr(limit, ctypes.c_int64), _ptr(duration, ctypes.c_int64),
        _ptr(algo, ctypes.c_int32), _ptr(gnp, ctypes.c_uint8),
        n, ctypes.c_uint64(buckets), n_shards,
        _ptr(rungs, ctypes.c_int64), rungs.shape[0], g_override,
        lo, hi, dlo, dhi,
        _ptr(order, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        _ptr(picked, ctypes.c_int64),
        _ptr(kh_o, ctypes.c_uint64), _ptr(hi_o, ctypes.c_int32),
        _ptr(li_o, ctypes.c_int32), _ptr(du_o, ctypes.c_int32),
        _ptr(al_o, ctypes.c_int32), _ptr(gn_o, ctypes.c_uint8),
        _ptr(va_o, ctypes.c_uint8),
        _ptr(gk_o, ctypes.c_uint64), _ptr(gl_o, ctypes.c_int32),
        _ptr(ge_o, ctypes.c_int32), _ptr(gv_o, ctypes.c_uint8),
        _ptr(gi_o, ctypes.c_int32),
        _ptr(take_idx, ctypes.c_int64),
    )
    if rc == -2:
        raise ValueError(
            f"group_rung {g_override} < max shard group count"
        )
    if rc != 0:
        raise RuntimeError(f"guber_prep_sharded failed: rc={rc}")
    B, G = int(picked[0]), int(picked[1])

    def view2(a, w):
        return a[: n_shards * w].reshape(n_shards, w)

    fields = dict(
        key_hash=view2(kh_o, B), hits=view2(hi_o, B),
        limit=view2(li_o, B), duration=view2(du_o, B),
        algo=view2(al_o, B), gnp=view2(gn_o, B).view(bool),
        valid=view2(va_o, B).view(bool),
    )
    groups = dict(
        key_hash=view2(gk_o, G), leader_pos=view2(gl_o, G),
        end_pos=view2(ge_o, G), valid=view2(gv_o, G).view(bool),
        group_id=view2(gi_o, B),
    )
    return order, counts, take_idx, fields, groups, B, G


try:
    _lib.guber_merge_runs.restype = ctypes.c_int64
    _vpp = ctypes.POINTER(ctypes.c_void_p)
    _lib.guber_merge_runs.argtypes = [
        _vpp, _vpp, _vpp, _vpp, _vpp, _vpp, _vpp, _vpp,
        _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int64,
        _u64p, _i32p, _u64p, _i32p, _i32p, _i32p, _i32p, _u8p, _u8p,
        _i32p, _i32p, _u64p, _i32p, _u8p, _i64p, _i64p,
    ]
    _HAS_MERGE = True
except AttributeError:
    _HAS_MERGE = False

try:
    _lib.guber_prep_run.restype = ctypes.c_int64
    _lib.guber_prep_run.argtypes = [
        _u64p, _i64p, _i64p, _i64p, _i32p, _u8p,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i64p, _u64p, _u64p, _i32p, _i32p, _i32p, _i32p, _u8p,
    ]
    _HAS_PREP_RUN = True
except AttributeError:
    _HAS_PREP_RUN = False


def prep_run(fields: dict, buckets: int, n_shards: int,
             lo: int, hi: int, dlo: int, dhi: int) -> dict:
    """Fused arrival-time per-group prep (guber_prep_run): sharded
    presort + device-dtype clip/gather of all six fields + the merged
    composite sort-key stream, in ONE GIL-free call — the producer
    side of merge_runs_native. Output layout matches the engines'
    numpy prep_run fallbacks bit-for-bit."""
    if not _HAS_PREP_RUN:
        raise AttributeError(
            "libguberhash.so predates guber_prep_run; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    kh = np.ascontiguousarray(fields["key_hash"], np.uint64)
    hits = np.ascontiguousarray(fields["hits"], np.int64)
    limit = np.ascontiguousarray(fields["limit"], np.int64)
    duration = np.ascontiguousarray(fields["duration"], np.int64)
    algo = np.ascontiguousarray(fields["algo"], np.int32)
    gnp = np.ascontiguousarray(np.asarray(fields["gnp"], bool).view(np.uint8))
    n = kh.shape[0]
    order = np.empty(n, np.int32)
    counts = np.empty(n_shards, np.int64)
    skey = np.empty(n, np.uint64)
    kh_o = np.empty(n, np.uint64)
    hits_o = np.empty(n, np.int32)
    lim_o = np.empty(n, np.int32)
    dur_o = np.empty(n, np.int32)
    algo_o = np.empty(n, np.int32)
    gnp_o = np.empty(n, np.uint8)
    rc = _lib.guber_prep_run(
        _ptr(kh, ctypes.c_uint64), _ptr(hits, ctypes.c_int64),
        _ptr(limit, ctypes.c_int64), _ptr(duration, ctypes.c_int64),
        _ptr(algo, ctypes.c_int32), _ptr(gnp, ctypes.c_uint8),
        n, ctypes.c_uint64(buckets), n_shards, lo, hi, dlo, dhi,
        _ptr(order, ctypes.c_int32), _ptr(counts, ctypes.c_int64),
        _ptr(skey, ctypes.c_uint64), _ptr(kh_o, ctypes.c_uint64),
        _ptr(hits_o, ctypes.c_int32), _ptr(lim_o, ctypes.c_int32),
        _ptr(dur_o, ctypes.c_int32), _ptr(algo_o, ctypes.c_int32),
        _ptr(gnp_o, ctypes.c_uint8),
    )
    if rc != 0:
        raise RuntimeError(f"guber_prep_run failed: rc={rc}")
    run = dict(
        n=n, skey=skey, order=order, counts=counts,
        fields=dict(
            key_hash=kh_o, hits=hits_o, limit=lim_o, duration=dur_o,
            algo=algo_o, gnp=gnp_o.view(bool),
        ),
    )
    run["_addrs"] = run_addrs(run)
    return run


def run_addrs(run: dict) -> tuple:
    """Raw data addresses of one prep run's arrays, in
    guber_merge_runs' table column order. prep_run stamps this into the
    run at arrival time so the flush-time merge pays zero per-run
    ctypes-interface construction on the submit thread."""
    f = run["fields"]
    return (
        run["skey"].ctypes.data,
        f["key_hash"].ctypes.data,
        f["hits"].ctypes.data,
        f["limit"].ctypes.data,
        f["duration"].ctypes.data,
        f["algo"].ctypes.data,
        f["gnp"].ctypes.data,
        run["order"].ctypes.data,
    )


def merge_runs_native(runs, B: int, g_rungs=None) -> dict:
    """Fused k-way merge of pre-sorted per-group runs (guber_merge_runs):
    one GIL-free pass produces the merged sort-key stream, the global
    caller-order permutation, all six device-dtype field arrays padded
    to B rows (tail repeats the last merged row, valid=False — the
    engine's padding convention; pass B == n for a flat merge), and the
    duplicate-key group stream. `runs` are engine prep_run dicts in
    caller order; ties across runs resolve in run order, so the merged
    permutation equals np.argsort(concat, kind='stable') — the
    merge-combine equivalence contract (tests/test_prep_pipeline.py).

    Returns dict(n, skey[n], order[B], key_hash/hits/limit/duration/
    algo[B], gnp/valid[B] (bool), group_id[n], leader_pos[n], G_real).
    With `g_rungs` (engine.group_rungs(B)), the group stream is padded
    in the same pass to the smallest fitting rung G — build_groups'
    conventions — and the dict gains G, group_key_hash/group_end/
    group_valid [:G], padded leader_pos [:G], and a B-sized group_id.
    """
    if not _HAS_MERGE:
        raise AttributeError(
            "libguberhash.so predates guber_merge_runs; rebuild with "
            "gubernator_tpu_torch/native/edge_build.build_hasher"
        )
    k = len(runs)
    n = int(sum(r["n"] for r in runs))
    assert B >= n, (B, n)

    # pointer tables from the per-run address tuples prep stamped at
    # ARRIVAL (run_addrs below) — `.ctypes.data` per array here would
    # cost ~8k ctypes-interface constructions of pure submit-thread
    # Python, which is exactly the wall this path exists to remove.
    # The run dicts keep the arrays alive for the duration of the call.
    addrs = [r.get("_addrs") or run_addrs(r) for r in runs]
    tabs = [
        (ctypes.c_void_p * k)(*[a[col] for a in addrs])
        for col in range(8)
    ]
    ns = np.asarray([r["n"] for r in runs], np.int64)
    bases = np.zeros(k, np.int64)
    np.cumsum(ns[:-1], out=bases[1:])

    if g_rungs is not None:
        rungs = np.ascontiguousarray(g_rungs, np.int64)
        g_max = int(rungs[-1])
    else:
        rungs = np.empty(0, np.int64)
        g_max = 0
    skey = np.empty(n, np.uint64)
    order = np.empty(B, np.int32)
    kh = np.empty(B, np.uint64)
    hits = np.empty(B, np.int32)
    limit = np.empty(B, np.int32)
    dur = np.empty(B, np.int32)
    algo = np.empty(B, np.int32)
    gnp = np.empty(B, np.uint8)
    valid = np.empty(B, np.uint8)
    gid = np.empty(max(B if g_rungs is not None else n, 1), np.int32)
    lead = np.empty(max(n, g_max, 1), np.int32)
    gkh = np.empty(max(g_max, 1), np.uint64)
    gend = np.empty(max(g_max, 1), np.int32)
    gvalid = np.empty(max(g_max, 1), np.uint8)
    g_real = ctypes.c_int64(0)
    g_pick = ctypes.c_int64(0)
    rc = _lib.guber_merge_runs(
        *tabs,
        _ptr(ns, ctypes.c_int64), _ptr(bases, ctypes.c_int64), k, B,
        _ptr(rungs, ctypes.c_int64), rungs.shape[0],
        _ptr(skey, ctypes.c_uint64), _ptr(order, ctypes.c_int32),
        _ptr(kh, ctypes.c_uint64), _ptr(hits, ctypes.c_int32),
        _ptr(limit, ctypes.c_int32), _ptr(dur, ctypes.c_int32),
        _ptr(algo, ctypes.c_int32), _ptr(gnp, ctypes.c_uint8),
        _ptr(valid, ctypes.c_uint8), _ptr(gid, ctypes.c_int32),
        _ptr(lead, ctypes.c_int32), _ptr(gkh, ctypes.c_uint64),
        _ptr(gend, ctypes.c_int32), _ptr(gvalid, ctypes.c_uint8),
        ctypes.byref(g_real), ctypes.byref(g_pick),
    )
    if rc != 0:
        raise RuntimeError(f"guber_merge_runs failed: rc={rc}")
    out = dict(
        n=n, skey=skey, order=order, key_hash=kh, hits=hits,
        limit=limit, duration=dur, algo=algo, gnp=gnp.view(bool),
        valid=valid.view(bool), G_real=int(g_real.value),
    )
    if g_rungs is not None:
        G = int(g_pick.value)
        out.update(
            G=G, group_id=gid, leader_pos=lead[:G],
            group_key_hash=gkh[:G], group_end=gend[:G],
            group_valid=gvalid[:G].view(bool),
        )
    else:
        out.update(group_id=gid[:n], leader_pos=lead[:n])
    return out


def unflatten_resp(packed, order, counts, n: int, b_sub: int) -> np.ndarray:
    """[4, n] response columns from a mesh packed matrix
    ([n_shards, 4*b_sub + stats] int32): the native twin of
    `out[order] = flat[take_idx]` per column. `b_sub` comes from the
    caller's handle — inferring it from the stride would silently skew
    every column if the stats tail ever grew."""
    packed = np.ascontiguousarray(packed, np.int32)
    n_shards, stride = packed.shape
    assert stride >= 4 * b_sub, (stride, b_sub)
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.empty((4, n), np.int32)
    _lib.guber_unflatten_resp(
        _ptr(packed, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(counts, ctypes.c_int64), n, n_shards, b_sub, stride,
        _ptr(out, ctypes.c_int32),
    )
    return out
