"""Single-device engine host glue (PyTorch port of
gubernator_tpu.core.engine, numpy path).

Pads batches to a small ladder of fixed sizes, presorts rows by (bucket,
fingerprint) on the host and derives the duplicate-key group structure
the decide runs its store I/O on, maps int64 unix-ms onto the store's
int32 engine-ms envelope (EpochClock) and unpermutes the responses. The
presorts, the marshal and the arrival prep run in the native library
(native/guberhash.cc, built at first use; `_native()`) when it loads,
as the JAX package's do; the numpy functions here are their plain twins,
byte-identical to them and to the JAX package's numpy path. The device
side takes the padded arrays as tensors (`to_device`) and runs
`decide_packed` (exact tier) or `decide_packed_sketch` (two-tier).
Arrival prep (`prep_run_single`, `build_presorted_request`) splits the
presort into per-group sorted runs that serve/prep.py merges.

The engine object itself is `TorchEngine` (parallel/sharded.py), also
importable from here as in the JAX package.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core.kernels import (
    BatchGroups,
    BatchRequest,
    decide_presorted,
    decide_presorted_sketch,
    pack_outputs,
)
from gubernator_tpu_torch.core.store import (
    COUNTER_MAX,
    MAX_DURATION_MS,
    REBASE_AT,
    TIME_FLOOR,
    group_sort_key_np,
    key_hash_tensor,
)
from gubernator_tpu_torch.native import load_hashlib

DEFAULT_BUCKETS = (64, 256, 1024, 4096)
DEEP_BUCKETS = (16384, 32768, 131072)


def buckets_for_limit(limit: int) -> tuple:
    """Padding buckets covering batches up to `limit` (the daemon's
    GUBER_DEVICE_BATCH_LIMIT): the ladder's rungs below it plus one
    final rung at the limit, rounded up to a multiple of 128."""
    base = [b for b in DEFAULT_BUCKETS + DEEP_BUCKETS if b < limit]
    base.append(-(-limit // 128) * 128)
    return tuple(base)


def group_rungs(b: int) -> tuple:
    """Group-count padding rungs for a request bucket of size b: compact
    rungs at 15b/64, b/4 and 3b/8 plus the full-size fallback (zipf
    batches carry G/B ~ 0.23-0.26)."""
    return tuple(
        sorted(
            {
                min(b, max(64, (15 * b) // 64)),
                min(b, max(64, b // 4)),
                min(b, max(64, (3 * b) // 8)),
                b,
            }
        )
    )


_I32_SAT = COUNTER_MAX


def _sat_i32(x: np.ndarray) -> np.ndarray:
    """Saturate int64 counters into int32."""
    return np.clip(np.asarray(x, np.int64), -_I32_SAT, _I32_SAT).astype(np.int32)


def _sat_duration(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x, np.int64), TIME_FLOOR, MAX_DURATION_MS).astype(
        np.int32
    )


class EpochClock:
    """Maps int64 unix-ms to the store's int32 engine-ms envelope.

    The epoch pins ONE millisecond before the first observed time, so
    live engine-ms values are >= 1 (0 is the wire's "no reset"
    sentinel). `advance` returns a rebase delta once offsets pass 2^30
    (~12.4 days), and reset_required for jumps a rebase cannot
    represent."""

    def __init__(self):
        self.epoch: Optional[int] = None

    def advance(self, now: int) -> Tuple[np.int32, Optional[int], bool]:
        """Returns (engine_now, rebase_delta, reset_required)."""
        now = int(now)
        if self.epoch is None:
            self.epoch = now - 1
        e = now - self.epoch
        if 0 <= e <= REBASE_AT:
            return np.int32(e), None, False
        self.epoch = now - 1
        e -= 1
        if -REBASE_AT < e <= _I32_SAT:
            return np.int32(1), e, False
        return np.int32(1), None, True

    def to_engine(self, t) -> np.ndarray:
        """int64 unix-ms (vector) -> int32 engine-ms, clamped."""
        assert self.epoch is not None
        return np.clip(
            np.asarray(t, np.int64) - self.epoch, TIME_FLOOR, _I32_SAT
        ).astype(np.int32)

    def from_engine(self, t32) -> np.ndarray:
        """int32 engine-ms -> int64 unix-ms; 0 passes through."""
        assert self.epoch is not None
        t = np.asarray(t32, np.int64)
        return np.where(t == 0, 0, t + self.epoch)


def choose_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest configured batch bucket holding n requests."""
    i = bisect.bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(f"batch of {n} exceeds max bucket {buckets[-1]}")
    return buckets[i]


def _native():
    """native/hashlib_native when the library builds and loads, else None
    (the numpy twins below serve)."""
    return load_hashlib()


def _np_presort(key_hash: np.ndarray, store_buckets: int) -> np.ndarray:
    return np.argsort(
        group_sort_key_np(key_hash, store_buckets), kind="stable"
    ).astype(np.int32)


def _presort(key_hash: np.ndarray, store_buckets: int) -> np.ndarray:
    """int32 stable argsort by (bucket, fingerprint): the native LSD
    radix presort, or its numpy twin."""
    hn = _native()
    if hn is not None:
        return hn.presort(key_hash, store_buckets)
    return _np_presort(key_hash, store_buckets)


def _presort_grouped(key_hash: np.ndarray, store_buckets: int):
    """(order, group_id, leader_pos, G_real): native, or the numpy twin."""
    hn = _native()
    if hn is not None:
        return hn.presort_grouped(key_hash, store_buckets)
    return _np_presort_grouped(key_hash, store_buckets)


def _np_presort_grouped(key_hash: np.ndarray, store_buckets: int):
    """(order, group_id, leader_pos, G_real) of a stable presort: the
    numpy twin of hashlib_native.presort_grouped."""
    skey = group_sort_key_np(key_hash, store_buckets)
    order = np.argsort(skey, kind="stable").astype(np.int32)
    s = skey[order]
    is_leader = np.empty(s.shape[0], bool)
    if s.shape[0]:
        is_leader[0] = True
        np.not_equal(s[1:], s[:-1], out=is_leader[1:])
    group_id = np.cumsum(is_leader).astype(np.int32) - 1
    leader_pos = np.flatnonzero(is_leader).astype(np.int32)
    return order, group_id, leader_pos, int(leader_pos.shape[0])


def build_groups(
    kh_padded: np.ndarray,
    group_id_n: np.ndarray,
    leader_pos_n: np.ndarray,
    G_real: int,
    n: int,
    B: int,
    G: int,
) -> BatchGroups:
    """Padded BatchGroups (numpy) from a grouped presort: padded group
    slots carry leader_pos=B / end_pos=B-1 / valid=False; the final real
    group owns the request padding tail; padded request rows point at
    the last real group; leader keys are gathered from the sorted
    padded key array."""
    leader_pos = np.full(G, B, np.int32)
    end_pos = np.full(G, B - 1, np.int32)
    g_valid = np.zeros(G, bool)
    if G_real:
        leader_pos[:G_real] = leader_pos_n[:G_real]
        end_pos[: G_real - 1] = leader_pos_n[1:G_real] - 1
        g_valid[:G_real] = True
    group_id = np.empty(B, np.int32)
    group_id[:n] = group_id_n[:n]
    group_id[n:] = max(G_real - 1, 0)
    return BatchGroups(
        key_hash=kh_padded[np.minimum(leader_pos, B - 1)],
        leader_pos=leader_pos,
        end_pos=end_pos,
        valid=g_valid,
        group_id=group_id,
    )


def pad_to_bucket(buckets: Sequence[int], n: int, *arrs):
    """Pad (array, dtype) pairs with zeros to the chosen bucket; returns
    (padded_arrays..., valid_mask)."""
    B = choose_bucket(buckets, n)
    out = []
    for x, dtype in arrs:
        p = np.zeros(B, dtype)
        p[:n] = x
        out.append(p)
    valid = np.zeros(B, bool)
    valid[:n] = True
    return (*out, valid)


def decide_packed(store, req, now, groups=None):
    """Exact-tier decide_presorted + pack_outputs: (store, packed), one
    host transfer per batch (the reference's _decide_packed_jit)."""
    store, resp, stats = decide_presorted(store, req, now, groups)
    return store, pack_outputs(resp, stats)


def decide_packed_sketch(store, sketch, req, now, groups=None):
    """Two-tier twin of decide_packed (the reference's
    _decide_packed_sketch_jit): store AND sketch update in place, the
    packed layout is identical, so decide_wait serves both."""
    store, sketch, resp, stats = decide_presorted_sketch(
        store, sketch, req, now, groups
    )
    return store, sketch, pack_outputs(resp, stats)


def pad_request_sorted(
    buckets: Sequence[int],
    store_buckets: int,
    key_hash: np.ndarray,
    hits: np.ndarray,
    limit: np.ndarray,
    duration: np.ndarray,
    algo: np.ndarray,
    gnp: np.ndarray,
    with_groups: bool = False,
):
    """Pad request arrays to a ladder rung and presort them by (bucket,
    fingerprint), the padding tail repeating the last sorted row's key
    with valid=False. Returns numpy (request, order) or (request, order,
    groups); order[i] is the caller's index of sorted row i (padding
    rows map to themselves), so `resp_orig[order] = resp_sorted`."""
    n = key_hash.shape[0]
    B = choose_bucket(buckets, n)
    hn = _native()

    if hn is not None and n and with_groups and hn.prep_threads() > 1:
        # one native call (guber_prep_sharded, one shard): presort, groups
        # and marshal fused, parallel over the library's prep pool; the
        # reference gates it to multi-thread hosts too, where it beats
        # the separate calls below. Its outputs are views into a
        # per-thread buffer ring (hashlib_native.set_prep_generations):
        # the request and groups are uploaded before the submit returns,
        # and `order` is built fresh here, so no handle keeps a view.
        order_w, _counts, _take, fields, groups_d, _B, _G = hn.prep_sharded(
            key_hash, hits, limit, duration, algo, gnp,
            store_buckets, 1, np.asarray([B], np.int64), 0,
            -_I32_SAT, _I32_SAT, TIME_FLOOR, MAX_DURATION_MS,
        )
        req = BatchRequest(**{k: v[0] for k, v in fields.items()})
        order = np.empty(B, np.int32)
        order[:n] = order_w
        order[n:] = np.arange(n, B, dtype=np.int32)
        return req, order, BatchGroups(
            key_hash=groups_d["key_hash"][0],
            leader_pos=groups_d["leader_pos"][0],
            end_pos=groups_d["end_pos"][0],
            valid=groups_d["valid"][0],
            group_id=groups_d["group_id"][0],
        )

    if with_groups:
        order_n, group_id_n, leader_pos_n, G_real = _presort_grouped(
            key_hash, store_buckets
        )
        G = choose_bucket(group_rungs(B), max(G_real, 1))
    else:
        order_n = _presort(key_hash, store_buckets)

    valid = np.zeros(B, bool)
    valid[:n] = True
    if hn is not None and n:
        # native one-pass gather + clip + pad of each field
        req = BatchRequest(
            key_hash=hn.gather_pad_u64(key_hash, order_n, B),
            hits=hn.gather_pad_i64_clip(hits, order_n, B, -_I32_SAT, _I32_SAT),
            limit=hn.gather_pad_i64_clip(limit, order_n, B, -_I32_SAT, _I32_SAT),
            duration=hn.gather_pad_i64_clip(
                duration, order_n, B, TIME_FLOOR, MAX_DURATION_MS
            ),
            algo=hn.gather_pad_i32(algo, order_n, B),
            gnp=hn.gather_pad_u8(
                np.asarray(gnp, bool).view(np.uint8), order_n, B
            ).view(bool),
            valid=valid,
        )
    else:
        def pad_sorted(x, dtype, sat=None):
            x = sat(x) if sat is not None else np.asarray(x, dtype)
            out = np.empty(B, dtype)
            out[:n] = x[order_n]
            out[n:] = out[n - 1] if n else 0
            return out

        req = BatchRequest(
            key_hash=pad_sorted(key_hash, np.uint64),
            hits=pad_sorted(hits, np.int32, _sat_i32),
            limit=pad_sorted(limit, np.int32, _sat_i32),
            duration=pad_sorted(duration, np.int32, _sat_duration),
            algo=pad_sorted(algo, np.int32),
            gnp=pad_sorted(gnp, bool),
            valid=valid,
        )
    order = np.empty(B, np.int32)
    order[:n] = order_n
    order[n:] = np.arange(n, B, dtype=np.int32)
    if with_groups:
        groups = build_groups(
            req.key_hash, group_id_n, leader_pos_n, G_real, n, B, G
        )
        return req, order, groups
    return req, order


def groups_from_sorted_keys(
    skey_sorted: np.ndarray, kh_padded: np.ndarray, n: int, B: int
) -> BatchGroups:
    """Duplicate-key group structure of an ALREADY-SORTED key stream:
    one O(n) diff instead of an argsort; bit-identical to the grouping
    pad_request_sorted derives."""
    is_leader = np.empty(n, bool)
    if n:
        is_leader[0] = True
        np.not_equal(skey_sorted[1:n], skey_sorted[: n - 1], out=is_leader[1:])
    group_id_n = np.cumsum(is_leader).astype(np.int32) - 1
    leader_pos_n = np.flatnonzero(is_leader).astype(np.int32)
    G_real = int(leader_pos_n.shape[0])
    G = choose_bucket(group_rungs(B), max(G_real, 1))
    return build_groups(kh_padded, group_id_n, leader_pos_n, G_real, n, B, G)


def pad_sorted_fields(fields: dict, n: int, B: int) -> BatchRequest:
    """BatchRequest from device-dtype arrays ALREADY in sorted order: the
    same tail pad_request_sorted emits (the last sorted row repeated,
    valid=False)."""

    def pad(x, dtype):
        out = np.empty(B, dtype)
        out[:n] = x
        out[n:] = out[n - 1] if n else 0
        return out

    valid = np.zeros(B, bool)
    valid[:n] = True
    return BatchRequest(
        key_hash=pad(fields["key_hash"], np.uint64),
        hits=pad(fields["hits"], np.int32),
        limit=pad(fields["limit"], np.int32),
        duration=pad(fields["duration"], np.int32),
        algo=pad(fields["algo"], np.int32),
        gnp=pad(fields["gnp"], bool),
        valid=valid,
    )


def prep_run_single(fields: dict, store_buckets: int) -> dict:
    """Arrival-time prep of one caller group (serve/batcher.py): presort
    it by (bucket, fingerprint) and clip every field into its device
    dtype, giving a sorted run that the flush-time merge (serve/prep.py)
    stitches into one batch. `order[j]` is the caller index of sorted row
    j; `counts` is the row count as a shape-[1] array (the reference's
    per-shard counts on its flat policy). One fused native call
    (guber_prep_run, without the GIL) when the library loads; the numpy
    below is its byte-identical twin."""
    hn = _native()
    if hn is not None:
        return hn.prep_run(
            fields, store_buckets, 1, -_I32_SAT, _I32_SAT, TIME_FLOOR,
            MAX_DURATION_MS,
        )
    kh = np.ascontiguousarray(fields["key_hash"], np.uint64)
    n = kh.shape[0]
    order = _np_presort(kh, store_buckets)
    sorted_fields = dict(
        key_hash=kh[order],
        hits=_sat_i32(fields["hits"])[order],
        limit=_sat_i32(fields["limit"])[order],
        duration=_sat_duration(fields["duration"])[order],
        algo=np.asarray(fields["algo"], np.int32)[order],
        gnp=np.asarray(fields["gnp"], bool)[order],
    )
    return dict(
        n=n,
        # the sort key is elementwise in the key hash, so computing it on
        # the SORTED hashes equals gathering the unsorted keys'
        skey=group_sort_key_np(sorted_fields["key_hash"], store_buckets),
        order=order,
        counts=np.array([n], np.int64),
        fields=sorted_fields,
    )


def build_presorted_request(
    buckets: Sequence[int], fields: dict, skey: np.ndarray, n: int
):
    """(req, groups, B) for an already-sorted batch: the merge-path twin
    of pad_request_sorted(with_groups=True), without its argsort and
    byte-identical to it."""
    B = choose_bucket(buckets, n)
    req = pad_sorted_fields(fields, n, B)
    groups = groups_from_sorted_keys(skey, req.key_hash, n, B)
    return req, groups, B


def to_device(batch, device: torch.device):
    """A BatchRequest/BatchGroups of numpy arrays as tensors on
    `device`; uint64 key hashes become int64 bit patterns."""
    out = []
    for x in batch:
        x = np.asarray(x)
        if x.dtype == np.uint64:
            out.append(key_hash_tensor(x, device))
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(x)).to(device))
    return type(batch)(*out)


def unpermute_responses(order: np.ndarray, sorted_arrays):
    """Inverse of pad_request_sorted's row order (`out[order] = sorted`)."""
    out = []
    for a in sorted_arrays:
        u = np.empty_like(a)
        u[order] = a
        out.append(u)
    return out


class EngineStats:
    """Monotonic counters; batch results land via add_batch under a
    lock."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.batches = 0
        self.dropped = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def add_batch(
        self, hits: int, misses: int, dropped: int = 0, evictions: int = 0
    ) -> None:
        with self._lock:
            self.hits += hits
            self.misses += misses
            self.dropped += dropped
            self.evictions += evictions
            self.batches += 1

    def snapshot(self):
        with self._lock:
            return dict(
                hits=self.hits,
                misses=self.misses,
                batches=self.batches,
                dropped=self.dropped,
                evictions=self.evictions,
            )


def __getattr__(name):
    # TorchEngine lives in parallel/sharded.py like the JAX package's
    # TpuEngine; this lazy alias avoids a core -> parallel import cycle.
    if name == "TorchEngine":
        from gubernator_tpu_torch.parallel.sharded import TorchEngine

        return TorchEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
