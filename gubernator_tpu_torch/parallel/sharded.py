"""Engines over one device or a list of devices (PyTorch port of
gubernator_tpu/parallel/sharded.py).

`TorchEngine` is the flat half of the reference's PartitionedEngine, its
single-device policy: host glue + the decide for a slot store resident on
one device, with or without the count-min cold tier. It presorts and pads
each batch on the host (core.engine; the merge of prepped runs and the
responses' unpermute run in the native prep library when it loads, as the
reference's do, numpy otherwise), copies the padded arrays to the device,
runs the exact-tier or two-tier decide (which update the store and sketch
tensors in place; JAX donates them instead), and fetches ONE packed int32
array of responses + stats per batch.

`MeshEngine` is its mesh policy (parallel/policy.py over_mesh): the key
space split over a list of shards by `owner_of`, each shard's store and
sub-sketch on its own device, every batch presorted by (owner, bucket,
fingerprint) into [n_shards, B_sub] sub-batches (pad_request_sharded,
or prep_run_sharded + build_presorted_sharded on the arrival-prep path),
each shard's decide run on its own rows, the packed rows of all shards
fetched together and unpermuted on the host. The reference's collectives
(the GLOBAL sync, the owner-masked row and sketch reads, the owner-masked
installs) are loops over the shard list whose sums land on the leader,
devices[0] (`_hier_psum`). A device may repeat, so one GPU (or the CPU)
holds any number of shards. Under a policy that spans processes
(parallel/multihost.py) each process holds its own contiguous run of the
global shards and decides its rows of every batch; the packed rows gather
to process 0 over torch.distributed, and each owner-masked sum adds one
all_reduce across processes.

Ported surfaces, on both: construction (optionally with a SketchConfig),
reset (bumping `reset_generation`, the shed cache's store-wipe epoch) and
the epoch clock with its store rebase (both clear the sketch), the
request-object API (get_rate_limits[_submit/_wait]), the array API
(decide_submit / decide_wait / decide_arrays), the arrival-prep path
(prep_run / merge_prepped / decide_submit_merged /
decide_submit_presorted), the GLOBAL surfaces (update_globals in both
call forms, sync_globals, apply_global_hits), the promoter's engine
surfaces (observe_hook, sketch_estimates, live_mask, snapshot_read,
install_windows, promote_from_sketch), warmup, load_state, which carries
a JAX engine's store, sketch and clock across, the quota-chain surface
(pad_request_chained, decide_chain_submit / decide_chain_arrays: chained
batches decide exact-only, the sketch untouched; over shards a chain goes
whole to its head's owner), and the durability surfaces: export_windows
(the full-store read of every live window that a checkpoint writes) and
repartition (export + install under another ShardingPolicy). The
multi-process mesh's lockstep wrapper is parallel/multihost.py.

Every submit path ends in `_dispatch`, which feeds `observe_hook` the
host-side numpy BatchRequest ([B] flat, [n_shards, B_sub] on a mesh) and
runs the decide; on a CUDA device the submit then starts non-blocking
copies of the packed outputs into pinned host memory and records an event
a device, so `decide_wait` waits for its own batch only, never for
batches submitted after it.

Spans: where the backend sets `stages` (the serving tier's stage clock,
serve/stages.py; the engine imports nothing of serve/), the submit records
`observe` (the hook), `launch` (upload and decide) and `readback` (the
output copy and its event), and decide_wait records `fetch_sync` (the
wait on the events) and `unpack` (the rest). `stats.groups` counts the
distinct keys of every dispatched batch that `stats` counts.

Thread model (the reference's): submits are serialized on one thread;
decide_wait calls may run concurrently on fetch threads, touching only
their own handle and the stats, which land under EngineStats' lock.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.core import hashing
from gubernator_tpu_torch.core.engine import (
    EngineStats,
    EpochClock,
    _gather_clip_sorted,
    _native,
    _sat_duration,
    _sat_i32,
    build_groups,
    build_presorted_request,
    choose_bucket,
    decide_packed,
    decide_packed_chain,
    decide_packed_sketch,
    dense_ladder_extension,
    extend_ladder,
    group_rungs,
    pad_request_sorted,
    pad_to_bucket,
    prep_run_single,
    to_device,
    unpermute_responses,
)
from gubernator_tpu_torch.core.graphs import (
    PROGRAMS,
    DecideLayout,
    DeviceGraphs,
    EagerPrograms,
    InstallLayout,
    ReadLayout,
    RequestLayout,
    copy_to_host,
    synchronize,
)
from gubernator_tpu_torch.core.kernels import (
    BatchGroups,
    BatchRequest,
    decide_presorted,
    sketch_min,
    unpack_outputs,
    upsert_globals,
    upsert_windows,
)
from gubernator_tpu_torch.core.sketches import (
    SketchConfig,
    new_sketch,
    sketch_indices_np,
    window_id_np,
)
from gubernator_tpu_torch.core.store import (
    COUNTER_MAX,
    FLAG_ALGO_LEAKY,
    FLAG_STICKY_OVER,
    L_DURATION,
    L_EXPIRE,
    L_FLAGS,
    L_KEYLOW,
    L_LIMIT,
    L_REMAINING,
    L_TAG,
    L_TS,
    LANES,
    MAX_DURATION_MS,
    TIME_FLOOR,
    DeviceLike,
    StoreConfig,
    _i64,
    _srl,
    bucket_index,
    fingerprints,
    group_sort_key_np,
    key_hash_tensor,
    mix64,
    new_store,
    rebase,
    resolve_device,
)
from gubernator_tpu_torch.parallel.policy import ShardingPolicy


_SHARD_SALT = np.uint64(0xA24BAED4963EE407)
_SHARD_SALT_I64 = _i64(0xA24BAED4963EE407)

#: store rows (128 MiB at 16 ways) that occupied_entries reads at once:
#: its temporaries stay a few MiB whatever the store's size
OCCUPIED_BLOCK_ROWS = 1 << 18

_log = logging.getLogger("gubernator_tpu_torch.sharded")
_warned_ladder_overflow = False


def _warn_ladder_overflow(top: int, n: int) -> None:
    """One-time note that a batch (or one shard's share of it) passed the
    configured ladder top: the rung progression is extended, so the pad
    grows 1.5x at a time (library callers only: the serving batcher caps
    batches at the ladder top)."""
    global _warned_ladder_overflow
    if not _warned_ladder_overflow:
        _warned_ladder_overflow = True
        _log.warning(
            "batch of %d exceeds the configured ladder top %d: extending the "
            "rung ladder; size the `buckets` ladder to your peak batch", n, top,
        )


def owner_of(key_hash: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning shard (int32) of each key hash (int64 bit patterns of the
    uint64 hashes), on the tensor's device: mix64(h ^ salt) mod n as an
    UNSIGNED 64-bit remainder. torch has no uint64 `%`, so the mixed hash
    splits into 32-bit halves: (hi * 2^32 + lo) mod n = ((hi mod n) *
    (2^32 mod n) + lo mod n) mod n, every term non-negative and below
    2^63. Bit-identical to owner_of_np."""
    x = mix64(key_hash ^ _SHARD_SALT_I64)
    hi = _srl(x, 32)
    lo = x & 0xFFFFFFFF
    n = int(n_shards)
    return (((hi % n) * ((1 << 32) % n) + lo % n) % n).to(torch.int32)


def owner_of_np(key_hash: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side twin of owner_of (numpy uint64)."""
    return (
        hashing.mix64(np.asarray(key_hash, np.uint64) ^ _SHARD_SALT)
        % np.uint64(n_shards)
    ).astype(np.int32)


def _owner_sort_keys(owner: np.ndarray, key_hash: np.ndarray, store_buckets: int):
    """The sharded presort's composite key: the owner's bits just above
    the (bucket << 32 | fp) group key, as guber_presort_sharded packs it."""
    bucket_bits = max(int(store_buckets).bit_length() - 1, 1)
    return (
        owner.astype(np.uint64) << np.uint64(32 + bucket_bits)
    ) | group_sort_key_np(key_hash, store_buckets)


def _np_presort_sharded(key_hash: np.ndarray, store_buckets: int, n_shards: int):
    """Numpy twin of the native sharded presort: stable argsort by
    (owner_shard, bucket, fingerprint) + per-shard counts."""
    owner = owner_of_np(key_hash, n_shards)
    comp = _owner_sort_keys(owner, key_hash, store_buckets)
    order = np.argsort(comp, kind="stable").astype(np.int32)
    counts = np.bincount(owner, minlength=n_shards).astype(np.int64)
    return order, counts


def _np_presort_sharded_grouped(key_hash: np.ndarray, store_buckets: int, n_shards: int):
    """Numpy twin of the native sharded+grouped presort: (order, counts,
    group_id, leader_pos, per-shard group counts)."""
    owner = owner_of_np(key_hash, n_shards)
    comp = _owner_sort_keys(owner, key_hash, store_buckets)
    order = np.argsort(comp, kind="stable").astype(np.int32)
    counts = np.bincount(owner, minlength=n_shards).astype(np.int64)
    s = comp[order]
    n = s.shape[0]
    is_leader = np.empty(n, bool)
    if n:
        is_leader[0] = True
        np.not_equal(s[1:], s[:-1], out=is_leader[1:])
    group_id = np.cumsum(is_leader).astype(np.int32) - 1
    leader_pos = np.flatnonzero(is_leader).astype(np.int32)
    bucket_bits = max(int(store_buckets).bit_length() - 1, 1)
    g_owner = (s[leader_pos] >> np.uint64(32 + bucket_bits)).astype(np.int64)
    group_counts = np.bincount(g_owner, minlength=n_shards).astype(np.int64)
    return order, counts, group_id, leader_pos, group_counts


def _presort_sharded(key_hash: np.ndarray, store_buckets: int, n_shards: int):
    hn = _native()
    if hn is not None:
        return hn.presort_sharded(key_hash, store_buckets, n_shards)
    return _np_presort_sharded(key_hash, store_buckets, n_shards)


def _presort_sharded_grouped(key_hash: np.ndarray, store_buckets: int, n_shards: int):
    hn = _native()
    if hn is not None:
        return hn.presort_sharded_grouped(key_hash, store_buckets, n_shards)
    return _np_presort_sharded_grouped(key_hash, store_buckets, n_shards)


def sub_batch_ladder(buckets: Sequence[int]) -> tuple:
    """Padding rungs for per-shard sub-batches: the host ladder densified
    with 1.5x midpoints (64, 96, 128, 192, ... between its min and max).
    A shard's count sits near B/n_shards with multinomial jitter, so the
    coarse 4x host ladder would pad a sub-batch up to 4x; the midpoints
    cap the waste at 1.5x."""
    lo, hi = min(buckets), max(buckets)
    rungs = set(buckets)
    p = lo
    while p < hi:
        rungs.add(p)
        rungs.add(min(p * 3 // 2, hi))
        p *= 2
    rungs.add(hi)
    return tuple(sorted(rungs))


def _take_idx(counts: np.ndarray, starts: np.ndarray, n: int, n_shards: int, B_sub: int):
    """take_idx[k]: the flattened [n_shards * B_sub] cell of global sorted
    row k (shard of k, k - the shard's start)."""
    shard_of_k = np.repeat(np.arange(n_shards, dtype=np.int64), counts)
    return shard_of_k * B_sub + (np.arange(n, dtype=np.int64) - starts[shard_of_k])


def _pad_src(counts: np.ndarray, starts: np.ndarray, n: int, B_sub: int):
    """(src, valid) of the [n_shards, B_sub] layout: padded cell (s, j)
    reads sorted row starts[s] + min(j, count - 1), repeating the shard's
    last row (an empty shard clamps to a neighbour), valid only below the
    shard's count."""
    j = np.arange(B_sub, dtype=np.int64)[None, :]
    src = starts[:-1, None] + np.minimum(j, np.maximum(counts[:, None] - 1, 0))
    np.clip(src, 0, max(n - 1, 0), out=src)
    return src, j < counts[:, None]


def pad_request_sharded(
    buckets: Sequence[int],
    store_buckets: int,
    n_shards: int,
    key_hash: np.ndarray,
    hits: np.ndarray,
    limit: np.ndarray,
    duration: np.ndarray,
    algo: np.ndarray,
    gnp: np.ndarray,
    with_groups: bool = False,
    group_rung: Optional[int] = None,
):
    """Partition a batch into per-shard sub-batches: the mesh sibling of
    engine.pad_request_sorted. One (owner, bucket, fp) presort makes each
    shard's rows a contiguous sorted run; every field becomes an
    [n_shards, B_sub] array (B_sub the rung holding the LARGEST shard's
    count) whose row s is shard s's sub-batch, padded by repeating its
    last row with valid=False.

    Returns numpy (req, order, take_idx), plus `groups` when with_groups:
    order[k] is the caller index of the k-th row in global sorted order,
    take_idx[k] its flattened [n_shards * B_sub] cell, and groups each
    shard's duplicate-key structure with indices LOCAL to its sub-batch.
    `group_rung` overrides the G rung (it must hold every shard's group
    count). Unpermute with `out[order] = resp_flat[take_idx]`. Mirrors
    gubernator_tpu/parallel/sharded.py:333."""
    n = key_hash.shape[0]
    if n == 0:
        # one all-invalid row per shard at the smallest rung
        B0 = min(buckets)
        req = BatchRequest(
            key_hash=np.zeros((n_shards, B0), np.uint64),
            hits=np.zeros((n_shards, B0), np.int32),
            limit=np.zeros((n_shards, B0), np.int32),
            duration=np.zeros((n_shards, B0), np.int32),
            algo=np.zeros((n_shards, B0), np.int32),
            gnp=np.zeros((n_shards, B0), bool),
            valid=np.zeros((n_shards, B0), bool),
        )
        empty = (req, np.empty(0, np.int32), np.empty(0, np.int64))
        if with_groups:
            G0 = group_rungs(B0)[0]
            return (*empty, BatchGroups(
                key_hash=np.zeros((n_shards, G0), np.uint64),
                leader_pos=np.full((n_shards, G0), B0, np.int32),
                end_pos=np.full((n_shards, G0), B0 - 1, np.int32),
                valid=np.zeros((n_shards, G0), bool),
                group_id=np.zeros((n_shards, B0), np.int32),
            ))
        return empty
    hn = _native()
    if hn is not None and with_groups:
        # one native call: presort + groups + marshal fused
        # (guber_prep_sharded), byte-identical to the numpy path below;
        # its arrays are views into a per-thread buffer ring, so callers
        # keeping order/take_idx past the next call copy them
        rungs = np.asarray(dense_ladder_extension(buckets, n), np.int64)
        order, counts, take_idx, fields, groups_d, _B_sub, _G = hn.prep_sharded(
            key_hash, hits, limit, duration, algo, gnp,
            store_buckets, n_shards, rungs,
            int(group_rung) if group_rung else 0,
            -COUNTER_MAX, COUNTER_MAX, TIME_FLOOR, MAX_DURATION_MS,
        )
        if int(counts.max()) > max(buckets):
            _warn_ladder_overflow(max(buckets), int(counts.max()))
        return BatchRequest(**fields), order, take_idx, BatchGroups(
            key_hash=groups_d["key_hash"],
            leader_pos=groups_d["leader_pos"],
            end_pos=groups_d["end_pos"],
            valid=groups_d["valid"],
            group_id=groups_d["group_id"],
        )

    if with_groups:
        order, counts, gid_g, lp_g, gcounts = _presort_sharded_grouped(
            key_hash, store_buckets, n_shards
        )
    else:
        order, counts = _presort_sharded(key_hash, store_buckets, n_shards)
    counts = counts.astype(np.int64)
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    maxc = max(int(counts.max()), 1)
    if maxc > max(buckets):
        _warn_ladder_overflow(max(buckets), maxc)
    B_sub = choose_bucket(extend_ladder(buckets, maxc), maxc)
    src, valid = _pad_src(counts, starts, n, B_sub)
    idx = order[src]  # caller index per padded cell

    def shard_field(x, dtype, sat=None):
        x = sat(x) if sat is not None else np.asarray(x, dtype)
        return x[idx]

    req = BatchRequest(
        key_hash=shard_field(key_hash, np.uint64),
        hits=shard_field(hits, np.int32, _sat_i32),
        limit=shard_field(limit, np.int32, _sat_i32),
        duration=shard_field(duration, np.int32, _sat_duration),
        algo=shard_field(algo, np.int32),
        gnp=shard_field(gnp, bool),
        valid=valid,
    )
    take_idx = _take_idx(counts, starts, n, n_shards, B_sub)
    if not with_groups:
        return req, order, take_idx
    groups = stack_shard_groups(
        req.key_hash, gid_g, lp_g, gcounts, counts, starts, n_shards, B_sub,
        group_rung,
    )
    return req, order, take_idx, groups


def stack_shard_groups(
    req_kh: np.ndarray,
    gid_g: np.ndarray,
    lp_g: np.ndarray,
    gcounts: np.ndarray,
    counts: np.ndarray,
    starts: np.ndarray,
    n_shards: int,
    B_sub: int,
    group_rung: Optional[int] = None,
) -> BatchGroups:
    """Per-shard group structure with LOCAL indices, each shard's built
    by engine.build_groups. Global group ids are contiguous in shard order
    (shard boundaries break groups), so shard s's groups are gstarts[s]
    .. gstarts[s + 1]. Shared by the flush-time presort
    (pad_request_sharded) and the merge (build_presorted_sharded)."""
    gstarts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(gcounts, out=gstarts[1:])
    if group_rung is not None:
        if group_rung < int(gcounts.max()):
            raise ValueError(
                f"group_rung {group_rung} < max shard group count {int(gcounts.max())}"
            )
        G_sub = group_rung
    else:
        G_sub = choose_bucket(group_rungs(B_sub), max(int(gcounts.max()), 1))
    per_shard = []
    for s in range(n_shards):
        gc, cs = int(gcounts[s]), int(counts[s])
        per_shard.append(build_groups(
            req_kh[s],
            gid_g[starts[s] : starts[s] + cs] - int(gstarts[s]),
            lp_g[gstarts[s] : gstarts[s] + gc] - int(starts[s]),
            gc, cs, B_sub, G_sub,
        ))
    return BatchGroups(*(np.stack(leaves) for leaves in zip(*per_shard)))


def sharded_sort_keys_np(key_hash: np.ndarray, store_buckets: int, n_shards: int) -> np.ndarray:
    """Composite host sort key of the sharded presort order: (owner |
    bucket | fingerprint), the packing the presorts order by."""
    kh = np.asarray(key_hash, np.uint64)
    return _owner_sort_keys(owner_of_np(kh, n_shards), kh, store_buckets)


def prep_run_sharded(fields: dict, store_buckets: int, n_shards: int) -> dict:
    """Arrival-time prep of one caller group for the mesh engine: presort
    by (owner, bucket, fingerprint), clip the fields to device dtypes and
    count rows per shard, a sorted run the flush-time merge
    (serve/prep.py) stitches into one sharded batch. One fused native call
    (guber_prep_run) when the library loads; the numpy is its twin."""
    hn = _native()
    if hn is not None:
        return hn.prep_run(
            fields, store_buckets, n_shards, -COUNTER_MAX, COUNTER_MAX,
            TIME_FLOOR, MAX_DURATION_MS,
        )
    kh = np.ascontiguousarray(fields["key_hash"], np.uint64)
    n = kh.shape[0]
    order, counts = _presort_sharded(kh, store_buckets, n_shards)
    sorted_fields = _gather_clip_sorted(fields, order, n)
    return dict(
        n=n,
        # elementwise in the key hash, so computed on the sorted hashes
        skey=sharded_sort_keys_np(sorted_fields["key_hash"], store_buckets, n_shards),
        order=order,
        counts=np.asarray(counts, np.int64),
        fields=sorted_fields,
    )


def build_presorted_sharded(
    sub_buckets: Sequence[int],
    store_buckets: int,
    n_shards: int,
    fields: dict,
    skey: np.ndarray,
    counts: np.ndarray,
):
    """(req, take_idx, groups, B_sub) of an already-sorted sharded batch:
    the merge twin of pad_request_sharded(with_groups=True), without its
    argsort and byte-identical to it."""
    n = skey.shape[0]
    counts = np.asarray(counts, np.int64)
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    maxc = max(int(counts.max()), 1)
    if maxc > max(sub_buckets):
        _warn_ladder_overflow(max(sub_buckets), maxc)
    B_sub = choose_bucket(extend_ladder(sub_buckets, maxc), maxc)
    # sorted_x[src] == x[order][src]: the same repeat-pad and clamp as
    # pad_request_sharded, gathered from the sorted stream directly
    src, valid = _pad_src(counts, starts, n, B_sub)
    req = BatchRequest(
        key_hash=fields["key_hash"][src],
        hits=fields["hits"][src],
        limit=fields["limit"][src],
        duration=fields["duration"][src],
        algo=fields["algo"][src],
        gnp=fields["gnp"][src],
        valid=valid,
    )
    # the group structure straight off the sorted keys: one diff pass
    is_leader = np.empty(n, bool)
    is_leader[0] = True
    np.not_equal(skey[1:], skey[:-1], out=is_leader[1:])
    gid_g = np.cumsum(is_leader).astype(np.int32) - 1
    lp_g = np.flatnonzero(is_leader).astype(np.int32)
    bucket_bits = max(int(store_buckets).bit_length() - 1, 1)
    g_owner = (skey[lp_g] >> np.uint64(32 + bucket_bits)).astype(np.int64)
    gcounts = np.bincount(g_owner, minlength=n_shards).astype(np.int64)
    groups = stack_shard_groups(
        req.key_hash, gid_g, lp_g, gcounts, counts, starts, n_shards, B_sub
    )
    return req, _take_idx(counts, starts, n, n_shards, B_sub), groups, B_sub


def pad_request_chained(
    buckets: Sequence[int],
    store_buckets: int,
    n_shards: int,
    key_hash: np.ndarray,
    hits: np.ndarray,
    limit: np.ndarray,
    duration: np.ndarray,
    algo: np.ndarray,
    chain_ids: np.ndarray,
    route_hash: np.ndarray,
):
    """Presort + pad one CHAINED batch: rows whose `chain_ids` match are
    one hierarchical request's levels and decide in one pass, so they
    must land on one shard. Ownership therefore follows `route_hash` (the
    chain head's key hash, the same for every row of a chain), while each
    row keeps its own key hash for its bucket. numpy only (the native
    prep has no chain column).

    Returns (req, order, take_idx, groups, chain_local), numpy. On one
    shard the layout is flat: req [B], take_idx None, chain_local int32[B]
    (each row's chain slot localized into [0, n) by np.unique, padding
    rows singleton chains at arange(n, B)). Over shards every field is
    [n_shards, B_sub] with the slots localized per shard. Mirrors
    gubernator_tpu/parallel/sharded.py:684-761."""
    kh = np.ascontiguousarray(key_hash, np.uint64)
    n = kh.shape[0]
    if n_shards > 1:
        owner = owner_of_np(np.ascontiguousarray(route_hash, np.uint64), n_shards)
        comp = _owner_sort_keys(owner, kh, store_buckets)
    else:
        comp = group_sort_key_np(kh, store_buckets)
    order = np.argsort(comp, kind="stable").astype(np.int32)
    s = comp[order]
    sorted_fields = _gather_clip_sorted(
        dict(
            key_hash=kh, hits=hits, limit=limit, duration=duration,
            algo=algo, gnp=np.zeros(n, bool),
        ),
        order,
        n,
    )
    chain_sorted = np.asarray(chain_ids, np.int64)[order]
    if n_shards == 1:
        req, groups, B = build_presorted_request(buckets, sorted_fields, s, n)
        chain_local = np.arange(B, dtype=np.int32)
        if n:
            _, inv = np.unique(chain_sorted, return_inverse=True)
            chain_local[:n] = inv.reshape(-1)  # values < n <= B
        return req, order, None, groups, chain_local

    counts = np.bincount(owner, minlength=n_shards).astype(np.int64)
    req, take_idx, groups, B_sub = build_presorted_sharded(
        buckets, store_buckets, n_shards, sorted_fields, s, counts
    )
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    chain_local = np.broadcast_to(
        np.arange(B_sub, dtype=np.int32), (n_shards, B_sub)
    ).copy()
    for sh in range(n_shards):
        c = int(counts[sh])
        if c:
            _, inv = np.unique(
                chain_sorted[starts[sh] : starts[sh] + c], return_inverse=True
            )
            chain_local[sh, :c] = inv.reshape(-1)  # values < c <= B_sub
    return req, order, take_idx, groups, chain_local


# -- the device programs of the installs, the GLOBAL step and the reads -------
# Each runs every shard of one device (`shards`: their global indices,
# in order; None on the flat engine, whose one store owns every key)
# from inputs those shards share (TorchEngine._device_shards). On the
# card each is captured as one graph a device (core/graphs.py); the CPU
# and cuda_graphs=False run the same programs eagerly, a device at a
# time (EagerPrograms), and the tests hold them against the reference's
# jitted programs.


def install_program(stores, shards, n: int, cols, full: bool) -> None:
    """One padded install chunk (cols: InstallLayout's columns as
    tensors) on each of `stores`, each shard keeping only the keys it
    owns: the reference's `_shard_upsert` / `_shard_upsert_full`
    (upsert_globals_jit / upsert_windows_jit on the flat engine). One
    writeback launch a store."""
    *tensors, valid = cols
    owner = None if shards is None else owner_of(tensors[0], n)
    for st, s in zip(stores, shards or (None,)):
        mine = valid if s is None else valid & (owner == s)
        (upsert_windows if full else upsert_globals)(st, *tensors, mine)


def sync_charge_program(stores, shards, n: int, req: BatchRequest, now) -> torch.Tensor:
    """The owner half of the reference's `_shard_sync_globals` on each
    of `stores`: each shard charges `req.hits` on the keys it owns (hits
    0: a peek) and keeps its answers for them; returns the sum of the
    shards' masked answers, int32[4, B] (status, limit, remaining,
    reset), their device's part of the owner-masked sum. One writeback
    launch a store."""
    owner = owner_of(req.key_hash, n)
    total = None
    for st, s in zip(stores, shards):
        m = owner == s
        _st, resp, _stats = decide_presorted(st, req._replace(valid=req.valid & m), now)
        keep = m & req.valid
        part = torch.stack([torch.where(keep, x, 0) for x in resp])
        total = part if total is None else total + part  # int32 wraps as psum
    return total


def sync_install_program(stores, shards, n: int, req: BatchRequest, total) -> None:
    """The replica half of `_shard_sync_globals`: every shard installs
    the summed windows (`total`, int32[4, B]) of the keys it does not
    own. One writeback launch a store."""
    owner = owner_of(req.key_hash, n)
    status, r_limit, remaining, reset = total
    for st, s in zip(stores, shards):
        upsert_globals(st, req.key_hash, r_limit, remaining, reset, status == 1,
                       req.valid & (owner != s))


def rows_program(stores, shards, n: int, kh: torch.Tensor, slots: int) -> torch.Tensor:
    """Each key's bucket row, int32[B, W]: the reference's `_rows_flat`
    on the flat engine; on a mesh the owner-masked sum of the shards'
    gathers (`_rows_sharded`, `_rows_coll`'s device part)."""
    b = bucket_index(kh, slots)
    if shards is None:
        return stores[0].data.index_select(0, b)
    owner = owner_of(kh, n)
    acc = None
    for st, s in zip(stores, shards):
        part = torch.where((owner == s)[:, None], st.data.index_select(0, b), 0)
        acc = part if acc is None else acc + part
    return acc


def sketch_min_program(sketches, shards, n: int, kh: torch.Tensor, idx) -> torch.Tensor:
    """Each key's count-min estimate at `idx` (int64[rows, B]): the
    reference's `_sketch_min_flat`; on a mesh the owner-masked sum of the
    shards' row-mins (`_sketch_min_sharded`, `_sketch_min_coll`'s device
    part)."""
    if shards is None:
        return sketch_min(sketches[0].data, idx)
    owner = owner_of(kh, n)
    acc = None
    for sk, s in zip(sketches, shards):
        part = torch.where(owner == s, sketch_min(sk.data, idx), 0)
        acc = part if acc is None else acc + part
    return acc


#: the pow2 rungs of the promoter's reads that the warmups walk (with a
#: sketch): a read graph missing there on a warmed engine raises
READ_RUNGS = (64, 128, 256, 512, 1024)


class TorchEngine:
    """Single-device engine over a slot store on `device` (cuda unless
    the caller passes another; see core.store.resolve_device), with the
    count-min cold tier beside it when `sketch` is a SketchConfig.

    On a GPU every decide is a replay of a captured CUDA graph, one per
    (program, request rung, group rung) (core/graphs.py), captured by
    `warmup` or on a shape's first use; so is every window install
    chunk, one per (token or full lanes, rung), and every state read
    (`snapshot_read`, `live_mask`, `sketch_estimates`), one per pow2
    rung. `cuda_graphs=False` runs them eagerly instead: the A/B leg of
    chip_smoke.py and the card tests set it, no serving path does. The
    store and sketch tensors are updated in place and never rebound,
    because the graphs hold their pointers.

    The warmup captures every decide pair, the token install at every
    rung and, with a sketch, the reads at READ_RUNGS; after it
    `graph_captures` and `program_captures` stay 0 on serving traffic.
    Captured on first use, and counted apart in `first_use_captures`
    (the reference too compiles them only then): the full-lane install
    (restore, handoff, repartition, replication) and reads at other
    rungs; the chain decide counts in `graph_captures`, as before."""

    def __init__(
        self,
        config: StoreConfig = StoreConfig(),
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        device: DeviceLike = None,
        sketch: Optional[SketchConfig] = None,
        cuda_graphs: bool = True,
    ):
        self._init_host(config, buckets, sketch)
        self.device = resolve_device(device)
        self.policy = ShardingPolicy.single(self.device)
        self.store = new_store(config, self.device)
        self.sketch = None if sketch is None else new_sketch(sketch, self.device)
        self.cuda_graphs = cuda_graphs
        self._new_graphs()

    def _init_host(self, config: StoreConfig, buckets: Sequence[int], sketch) -> None:
        """The host-side state every engine carries, whatever its policy."""
        self.config = config
        self.buckets = sorted(buckets)
        # shards: writeback launches a decide, install chunk or gossip
        # chunk make on a GPU (one each on the flat engine)
        self.n = 1
        self.clock = EpochClock()
        self.stats = EngineStats()
        # the writebacks no decide batch counts: each window-install chunk
        # and each gossip-charge chunk is one writeback launch, so on a GPU
        # the launches are stats.batches + install_chunks + gossip_chunks
        self.install_chunks = 0
        self.gossip_chunks = 0
        # on a GPU, CUDA events around every counted decide (from before
        # its upload to the end of its download) sum into device_span_ms:
        # the card's time inside decides, read without the profiler
        self.device_span_ms = 0.0
        # bumped by every reset(): the store-wipe epoch the over-limit
        # shed cache checks (serve/shedcache.py)
        self.reset_generation = 0
        # serve-tier hot-key observer (serve/promoter.py): called with
        # every dispatched numpy BatchRequest, before it goes to the
        # device; must never fail a dispatch
        self.observe_hook = None
        # the stage clock the submit and fetch spans go to (set by the
        # serving backend, as observe_hook is); None records nothing
        self.stages = None
        # `sketch_on` flips between the two-tier and the exact-only
        # decide at run time (the reference's A/B flag)
        self.sketch_config = sketch
        self.sketch_on = sketch is not None
        # the last export_windows: its wall ms, split into the live-entry
        # mask on the device (through the sync its count needs) and the
        # copy to the host; the bytes copied off the device; the windows
        self.last_export = dict(ms=0.0, mask_ms=0.0, copy_ms=0.0, bytes=0, windows=0)
        # the flat engine's captured programs (core/graphs.py; on a GPU
        # only; a mesh holds one set a device, MeshEngine.device_graphs),
        # the seconds the last warmup spent capturing them (all, and the
        # non-decide programs'), and whether a warmup filled them
        self.cuda_graphs = True
        self.graphs = None
        self.capture_s = 0.0
        self.program_capture_s = 0.0
        self._warmed = False

    @property
    def n_local(self) -> int:
        """The shards this process holds: its writeback launches a
        decide, an install chunk or a gossip chunk on a GPU."""
        return self.n

    def _span(self, name: str, t0: float) -> None:
        """Record the span `name` from `t0` (time.monotonic) to now into
        the stage clock, if the backend set one."""
        stages = self.stages
        if stages is not None:
            t1 = time.monotonic()
            stages.add(name, t1 - t0, end=t1)

    def _observe(self, req, groups, observe: bool) -> None:
        """The dispatch funnel's host-side bookkeeping of a decide batch:
        count its groups (distinct keys; `valid` marks them) and feed the
        hot-key observer. `observe=False` (a GLOBAL gossip chunk, which
        `stats` leaves out) does neither."""
        if not observe:
            return
        self.stats.add_groups(int(np.count_nonzero(groups.valid)))
        hook = self.observe_hook
        if hook is not None:
            t0 = time.monotonic()
            try:
                hook(req)
            except Exception:  # pragma: no cover - defensive
                pass  # observability must never fail a dispatch
            self._span("observe", t0)

    def _staging_bytes(self, rung: int, rows: int) -> int:
        """The staging slots' first size: the largest layout a set of
        `rows` rows uploads at the ladder's top (decide rung `rung`)."""
        top = max(self.buckets)
        return max(DecideLayout(rung, rung, True, rows).nbytes,
                   InstallLayout(top, True).nbytes, RequestLayout(top).nbytes)

    def _new_graphs(self) -> None:
        """An empty set of captured programs (on a GPU with graphs on)."""
        self._warmed = False
        if self.cuda_graphs and self.device.type == "cuda":
            self.graphs = DeviceGraphs(self.device, self._staging_bytes(max(self.buckets), 1))

    def _graph_sets(self) -> list:
        """Every DeviceGraphs of the engine (one flat, one a device on a
        mesh; none on the CPU or with cuda_graphs=False)."""
        return [] if self.graphs is None else [self.graphs]

    @property
    def graph_count(self) -> int:
        """Captured decide graphs, one per (program, B, G) used so far (a
        device)."""
        return sum(g.count(decide=True) for g in self._graph_sets())

    @property
    def graph_captures(self) -> int:
        """Decide graphs captured on first use since the last warmup (a
        shape the warmup did not reach, or the chain program): the
        counterpart of a JAX recompile."""
        return sum(g.captures for g in self._graph_sets())

    @property
    def program_graph_count(self) -> int:
        """Captured graphs of the other programs (installs, GLOBAL steps,
        reads), one per (program, rung) used so far (a device)."""
        return sum(g.count(decide=False) for g in self._graph_sets())

    @property
    def program_captures(self) -> int:
        """Captures since the last warmup of the programs it walks (token
        installs, GLOBAL steps): 0 on a warmed engine's serving traffic."""
        return sum(g.program_captures for g in self._graph_sets())

    @property
    def first_use_captures(self) -> int:
        """Captures since the last warmup of the programs the reference
        too compiles only on first use: full-lane installs, reads past
        the walked rungs."""
        return sum(g.first_use_captures for g in self._graph_sets())

    @property
    def graph_pool_bytes(self) -> int:
        """Bytes the card holds in the graphs' shared memory pools."""
        return sum(g.pool_bytes() for g in self._graph_sets())

    def _graphs_warmed(self) -> None:
        """The end of a warmup (`warmup`, `warmup_public`, the only
        callers: they walk the reads' rungs): keep its capture seconds,
        zero the graphs' capture and replay counts; from now on a read
        graph missing at a walked rung raises."""
        sets = self._graph_sets()
        self.capture_s = sum(g.capture_s for g in sets)
        self.program_capture_s = sum(g.program_capture_s for g in sets)
        for g in sets:
            g.zero_counts()
        self._warmed = bool(sets)

    def _read(self, g, key: tuple, record, args, layout):
        """Run a read's program on `g`: at a rung the warmup walks (with a
        sketch) a warmed engine must hold its graph, elsewhere it is
        captured on first use."""
        walked = self.sketch is not None and key[1] in READ_RUNGS
        if walked and self._warmed and key not in g.graphs:
            raise RuntimeError(f"read graph {key} missing on a warmed engine")
        return g.run(key, record, args, lambda: layout, first_use=not walked)

    def close(self) -> None:
        """Release the captured graphs and their memory pools (an engine
        replaced by repartition); the engine may still decide, capturing
        again."""
        for g in self._graph_sets():
            g.close()
        self._new_graphs()

    # -- per-shard state (one shard here; MeshEngine has n) --------------------

    def _shard_stores(self) -> list:
        return [self.store]

    def _device_shards(self):
        """(device, its programs' runner, its stores, their sketches or
        None, their global shard indices) for each distinct device, in
        shard order: what one run of an install, GLOBAL step or read
        program covers. The runner is the device's DeviceGraphs, else
        EagerPrograms (the CPU, cuda_graphs=False). Here one device whose
        one store owns every key (shard indices None)."""
        g = EagerPrograms(self.device) if self.graphs is None else self.graphs
        yield (self.device, g, [self.store], None if self.sketch is None else [self.sketch],
               None)

    def _psum(self, parts: list) -> torch.Tensor:
        """The owner-masked sum of the devices' parts: here the one part."""
        return parts[0]

    def _shard_sketches(self) -> list:
        return [] if self.sketch is None else [self.sketch]

    def _state_lead(self) -> tuple:
        """The leading axes of the state arrays load_state and
        store_numpy speak: none flat, (n_shards,) on a mesh."""
        return ()

    def store_numpy(self) -> np.ndarray:
        """The store's bytes on the host: int32[buckets, W] flat,
        [n_shards, buckets, W] on a mesh (the reference's
        `np.asarray(store.data)`)."""
        out = np.stack([s.data.cpu().numpy() for s in self._shard_stores()])
        return out.reshape(self._state_lead() + out.shape[1:])

    def sketch_numpy(self) -> Optional[np.ndarray]:
        """The sketch counters on the host, laid out as store_numpy's
        (None without the tier)."""
        sks = self._shard_sketches()
        if not sks:
            return None
        out = np.stack([s.data.cpu().numpy() for s in sks])
        return out.reshape(self._state_lead() + out.shape[1:])

    def occupied_entries(self) -> int:
        """Entries of every shard's store with a tag set, live or expired
        (the count upstream's LRU reports as its size): counted on the
        device `OCCUPIED_BLOCK_ROWS` rows at a time, so no temporary
        grows with the store, in stream order after the batches already
        submitted, with one sync a device. Recorded as the `store_size`
        stage."""
        t0 = time.monotonic()
        counts = {}
        for st in self._shard_stores():
            data = st.data
            n = counts.setdefault(
                data.device, torch.zeros((), dtype=torch.int64, device=data.device))
            for s in range(0, data.shape[0], OCCUPIED_BLOCK_ROWS):
                block = data[s : s + OCCUPIED_BLOCK_ROWS]
                n += torch.count_nonzero(block.view(-1, LANES)[:, L_TAG])
        total = sum(int(n.item()) for n in counts.values())
        self._span("store_size", t0)
        return total

    def reset(self) -> None:
        """Wipe the store and the sketch in place (the clock keeps its
        epoch)."""
        for st in self._shard_stores():
            st.data.zero_()
        for sk in self._shard_sketches():
            sk.data.zero_()
        self.reset_generation += 1

    def _engine_now(self, now: int) -> np.int32:
        e, delta, reset_required = self.clock.advance(now)
        if reset_required:
            self.reset()
        elif delta is not None:
            for st in self._shard_stores():
                rebase(st, delta)
            # sketch windows are keyed by engine-ms // duration: a rebase
            # moves every window id, so the counts are cleared
            for sk in self._shard_sketches():
                sk.data.zero_()
        return e

    def load_state(
        self,
        store_np: np.ndarray,
        epoch: Optional[int],
        sketch_np: Optional[np.ndarray] = None,
    ) -> None:
        """Carry another engine's state across: the store bytes (a JAX
        TpuEngine's `np.asarray(store.data)`, int32[buckets, W]; a JAX
        MeshEngine's, [n_shards, buckets, W]), its clock epoch
        (`clock.epoch`) and, for a two-tier engine, its sketch counters
        (`np.asarray(sketch.data)`, int32 or int64 [rows, width], with the
        shard axis in front on a mesh); a two-tier engine given no sketch
        starts with an empty one."""
        stores, sketches = self._shard_stores(), self._shard_sketches()
        lead = self._state_lead()
        want = lead + tuple(stores[0].data.shape)
        if store_np.dtype != np.int32 or tuple(store_np.shape) != want:
            raise ValueError(
                f"store {store_np.dtype}{list(store_np.shape)} does not "
                f"match this engine's int32{list(want)}"
            )
        if sketch_np is not None:
            if not sketches:
                raise ValueError("this engine has no sketch tier to load into")
            sk = sketches[0].data
            want_dtype = np.int32 if sk.dtype == torch.int32 else np.int64
            want_sk = lead + tuple(sk.shape)
            if sketch_np.dtype != want_dtype or tuple(sketch_np.shape) != want_sk:
                raise ValueError(
                    f"sketch {sketch_np.dtype}{list(sketch_np.shape)} does not "
                    f"match this engine's {sk.dtype}{list(want_sk)}"
                )
        arr = np.require(store_np, requirements=["C", "W"]).reshape(
            (len(stores),) + tuple(stores[0].data.shape)
        )
        for st, a in zip(stores, arr):
            st.data.copy_(torch.from_numpy(a))
        if sketch_np is None:
            for sk in sketches:
                sk.data.zero_()
        elif sketches:
            sk_arr = np.require(sketch_np, requirements=["C", "W"]).reshape(
                (len(sketches),) + tuple(sketches[0].data.shape)
            )
            for sk, a in zip(sketches, sk_arr):
                sk.data.copy_(torch.from_numpy(a))
        self.clock.epoch = None if epoch is None else int(epoch)

    # -- request-object API --------------------------------------------------

    def get_rate_limits_submit(
        self,
        reqs: Sequence["api_types.RateLimitReq"],
        now: Optional[int] = None,
        gnp: Optional[Sequence[bool]] = None,
    ):
        """Convert + presort + dispatch one batch of request objects
        without waiting; returns a handle for get_rate_limits_wait, or
        None for an empty batch."""
        from gubernator_tpu_torch.core.hashing import slot_hash_batch

        n = len(reqs)
        if n == 0:
            return None
        if now is None:
            now = api_types.millisecond_now()
        hashes = slot_hash_batch([r.hash_key() for r in reqs])
        hits = np.fromiter((r.hits for r in reqs), np.int64, n)
        limit = np.fromiter((r.limit for r in reqs), np.int64, n)
        duration = np.fromiter((r.duration for r in reqs), np.int64, n)
        algo = np.fromiter((int(r.algorithm) for r in reqs), np.int32, n)
        gnp_arr = np.asarray(gnp, bool) if gnp is not None else np.zeros(n, bool)
        return self.decide_submit(hashes, hits, limit, duration, algo, gnp_arr, now)

    def get_rate_limits_wait(self, handle):
        if handle is None:
            return []
        return api_types.resps_from_columns(*self.decide_wait(handle))

    def get_rate_limits(
        self,
        reqs: Sequence["api_types.RateLimitReq"],
        now: Optional[int] = None,
        gnp: Optional[Sequence[bool]] = None,
    ):
        """Decide a batch. `gnp[i]` marks GLOBAL non-owner replica reads."""
        return self.get_rate_limits_wait(
            self.get_rate_limits_submit(reqs, now=now, gnp=gnp)
        )

    # -- array decide paths --------------------------------------------------

    def _dispatch(self, req, groups, e_now, observe: bool = True, chain_id=None):
        """The one dispatch funnel of every submit path: feed the hot-key
        observer the numpy batch (unless `observe` is False), copy it to
        the device and run the exact-only or the two-tier decide there,
        or with `chain_id` (numpy int32[B]) the quota-chain decide, which
        is exact-only; returns (the packed output tensor, the CUDA event
        recorded before the upload, or None off the card). On a GPU with
        graphs the copy is one staged upload and the decide a replay
        (core/graphs.py); a capture or replay that fails raises."""
        self._observe(req, groups, observe)
        if chain_id is not None:
            program = "chain"
        elif self.sketch is not None and self.sketch_on:
            program = "sketch"
        else:
            program = "exact"
        t0 = time.monotonic()
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            if self.graphs is not None:
                packed = self.graphs.decide(
                    program, [self.store], [self.sketch], req, groups, e_now, chain_id
                )
                self._span("launch", t0)
                return packed[0], start
        req_t = to_device(req, self.device)
        groups_t = to_device(groups, self.device)
        chain_t = None if chain_id is None else torch.from_numpy(chain_id).to(self.device)
        packed = PROGRAMS[program](self.store, self.sketch, req_t, groups_t, e_now, chain_t)
        self._span("launch", t0)
        return packed, start

    def decide_submit(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        gnp: np.ndarray,
        now: int,
        observe: bool = True,
    ):
        """Presort + dispatch one batch WITHOUT waiting for the device.
        The store update is queued on the device stream at once, so the
        next submit may follow immediately. Returns a handle for
        decide_wait that captures the submit-time epoch. `observe=False`
        keeps the batch from the hot-key observer."""
        n = key_hash.shape[0]
        e_now = self._engine_now(now)
        req, order, groups = pad_request_sorted(
            self.buckets,
            self.config.slots,
            key_hash,
            hits,
            limit,
            duration,
            algo,
            gnp,
            with_groups=True,
        )
        packed, start = self._dispatch(req, groups, e_now, observe)
        return self._handle(packed, start, order, n, req.key_hash.shape[0])

    def _handle(self, packed: torch.Tensor, start, order: np.ndarray, n: int, B: int):
        """decide_wait's handle for one dispatched batch: (packed host
        tensor, its copy's event or None, the decide's start event or
        None, order, n, B, epoch). On CUDA the packed outputs start
        copying into pinned host memory at once and the event marks that
        copy's end in stream order."""
        t0 = time.monotonic()
        event = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            packed = host
        self._span("readback", t0)
        return packed, event, start, order, n, B, self.clock.epoch

    def prep_run(self, fields: dict) -> dict:
        """Arrival-time prep of one caller group (serve/batcher.py): a
        sorted, device-dtype run for the flush-time merge."""
        return prep_run_single(fields, self.config.slots)

    def merge_prepped(self, runs) -> dict:
        """Merge pre-sorted per-group runs into one dispatch-ready batch
        (the submit thread's `merge` stage)."""
        from gubernator_tpu_torch.serve.prep import merge_runs

        n = int(sum(r["n"] for r in runs))
        hn = _native()
        if hn is not None and n:
            # one GIL-free native pass: merge, pad to the rung B and build
            # the group stream padded to its rung. Its arrays are fresh
            # for every call (no buffer ring), so the handle may keep them
            B = choose_bucket(self.buckets, n)
            m = hn.merge_runs_native(runs, B, g_rungs=group_rungs(B))
            req = BatchRequest(
                key_hash=m["key_hash"], hits=m["hits"], limit=m["limit"],
                duration=m["duration"], algo=m["algo"], gnp=m["gnp"],
                valid=m["valid"],
            )
            groups = BatchGroups(
                key_hash=m["group_key_hash"], leader_pos=m["leader_pos"],
                end_pos=m["group_end"], valid=m["group_valid"],
                group_id=m["group_id"],
            )
            return dict(req=req, groups=groups, order=m["order"], n=n, B=B)
        m = merge_runs(runs)
        req, groups, B = build_presorted_request(self.buckets, m["fields"], m["skey"], n)
        order_p = np.empty(B, np.int32)
        order_p[:n] = m["order"]
        order_p[n:] = np.arange(n, B, dtype=np.int32)
        return dict(req=req, groups=groups, order=order_p, n=n, B=B)

    def decide_submit_merged(self, merged: dict, now: int):
        """Dispatch a merge_prepped batch: epoch bookkeeping + the decide
        (the submit thread's `dispatch` stage). Handle as decide_submit's."""
        e_now = self._engine_now(now)
        packed, start = self._dispatch(merged["req"], merged["groups"], e_now)
        return self._handle(packed, start, merged["order"], merged["n"], merged["B"])

    def decide_submit_presorted(
        self,
        fields: dict,
        skey: np.ndarray,
        order: Optional[np.ndarray],
        counts: np.ndarray,
        now: int,
    ):
        """Dispatch a batch whose host presort already happened: `fields`
        are device-dtype arrays in sorted order, `skey` their sorted keys,
        `order[k]` the caller index of sorted row k (None = identity);
        `counts` is the reference's per-shard row count (unused on one
        device). Pads and derives the groups in O(n), no argsort."""
        n = skey.shape[0]
        if n == 0:
            return None
        e_now = self._engine_now(now)
        req, groups, B = build_presorted_request(self.buckets, fields, skey, n)
        order_p = np.empty(B, np.int32)
        order_p[:n] = order if order is not None else np.arange(n, dtype=np.int32)
        order_p[n:] = np.arange(n, B, dtype=np.int32)
        packed, start = self._dispatch(req, groups, e_now)
        return self._handle(packed, start, order_p, n, B)

    def decide_wait(
        self, handle, count: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fetch + unpermute the responses for a decide_submit handle:
        (status, limit, remaining, reset_time int64 unix-ms). Waits on
        this batch's own copy event only. `count=False` leaves the batch
        out of `stats`."""
        packed, event, start, order, n, B, epoch = handle
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
            if count and start is not None:
                self.device_span_ms += start.elapsed_time(event)
        self._span("fetch_sync", t0)
        t0 = time.monotonic()
        packed = packed.numpy()
        if count:
            self.stats.add_batch(
                int(packed[4 * B]),
                int(packed[4 * B + 1]),
                int(packed[4 * B + 2]),
                int(packed[4 * B + 3]),
            )
        hn = _native()
        if hn is not None:
            # native one-pass unpermute of the four response columns
            u = hn.unpermute_i32(packed[: 4 * B].reshape(4, B), order, n)
            status, rlimit, remaining, reset = u[0], u[1], u[2], u[3]
        else:
            status, rlimit, remaining, reset = unpermute_responses(
                order, unpack_outputs(packed, B)[:4]
            )
        r = np.asarray(reset[:n], np.int64)
        reset = np.where(r == 0, 0, r + epoch)
        self._span("unpack", t0)
        return status[:n], rlimit[:n], remaining[:n], reset

    def decide_arrays(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        gnp: np.ndarray,
        now: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Array-level entry point: submit + wait (int64 unix-ms in/out)."""
        return self.decide_wait(
            self.decide_submit(key_hash, hits, limit, duration, algo, gnp, now)
        )

    # -- quota chains --------------------------------------------------------

    def decide_chain_submit(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        chain_ids: np.ndarray,
        route_hash: np.ndarray,
        now: int,
    ):
        """Dispatch one CHAINED batch without waiting: rows sharing a
        `chain_ids` value are one hierarchical request's levels, decided
        together under the no-partial-debit contract
        (kernels.decide_presorted_chain); `route_hash` is the chain head's
        key hash per row. Exact-only (the sketch is untouched) and on the
        numpy prep. The handle is decide_wait's."""
        n = key_hash.shape[0]
        e_now = self._engine_now(now)
        req, order, _take, groups, chain_local = pad_request_chained(
            self.buckets, self.config.slots, 1, key_hash, hits, limit,
            duration, algo, chain_ids, route_hash,
        )
        B = req.key_hash.shape[0]
        packed, start = self._dispatch(req, groups, e_now, chain_id=chain_local)
        order_p = np.empty(B, np.int32)
        order_p[:n] = order
        order_p[n:] = np.arange(n, B, dtype=np.int32)
        return self._handle(packed, start, order_p, n, B)

    def decide_chain_arrays(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        chain_ids: np.ndarray,
        route_hash: np.ndarray,
        now: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Array-level chained decide: submit + wait (int64 unix-ms in
        and out, like decide_arrays)."""
        return self.decide_wait(
            self.decide_chain_submit(
                key_hash, hits, limit, duration, algo, chain_ids, route_hash, now
            )
        )

    # -- host-side state reads (non-mutating) --------------------------------

    @staticmethod
    def _pad_keys_pow2(key_hash: np.ndarray, *cols):
        """Pad key hashes (+ parallel int64 columns) to a power-of-two
        length (floor 64) by repeating the last row, so the reads run at
        a few fixed shapes. Returns (kh, cols..., n)."""
        n = int(key_hash.shape[0])
        B = 1 << max(6, (n - 1).bit_length())
        kh = np.empty(B, np.uint64)
        kh[:n] = key_hash
        kh[n:] = kh[n - 1] if n else 0
        out = [kh]
        for c in cols:
            p = np.empty(B, np.int64)
            p[:n] = c
            p[n:] = p[n - 1] if n else 0
            out.append(p)
        out.append(n)
        return tuple(out)

    def _gather_entries(self, kh_padded: np.ndarray):
        """(rows int32[B, ways, LANES], fp int32[B]) as host arrays: each
        key's bucket row and tag, gathered on the device from its owner's
        store (rows_program a device, the parts' owner-masked sum; on the
        card one graph replay a device a pow2 rung, the sum copied to
        pinned host memory and waited on alone). The one lookup
        snapshot_read and live_mask share."""
        B = kh_padded.shape[0]
        layout = ReadLayout(B)
        parts = []
        for dev, g, stores, _sks, shards in self._device_shards():
            with _on(dev):
                parts.append(self._read(
                    g, ("rows", B, 0),
                    lambda static: rows_program(stores, shards, self.n,
                                                layout.views(static)[0], self.config.slots),
                    (kh_padded,), layout,
                ))
        rows = copy_to_host(self._psum(parts))
        return (rows.numpy().reshape(B, -1, LANES),
                fingerprints(key_hash_tensor(kh_padded)).numpy())

    def snapshot_read(self, key_hash: np.ndarray, now: Optional[int] = None):
        """NON-MUTATING host read of the store for these uint64 key
        hashes: per key, (limit, duration, remaining, reset_time_unix,
        over) for a live non-leaky window, or None (missing, expired or
        leaky). Nothing is written: no eviction, no expiry, no stats."""
        n = int(key_hash.shape[0])
        if n == 0:
            return []
        if self.clock.epoch is None:
            return [None] * n  # nothing ever decided
        if now is None:
            now = api_types.millisecond_now()
        kh_p, _n = self._pad_keys_pow2(np.ascontiguousarray(key_hash, np.uint64))
        ent_rows, fp = self._gather_entries(kh_p)
        ent_rows, fp = ent_rows[:n], fp[:n]
        match = ent_rows[:, :, L_TAG] == fp[:, None]
        found = match.any(axis=1)
        ent = ent_rows[np.arange(n), np.argmax(match, axis=1)]
        e_now = int(self.clock.to_engine(now))
        out = []
        for i in range(n):
            flags = int(ent[i, L_FLAGS])
            if not found[i] or int(ent[i, L_EXPIRE]) < e_now or flags & FLAG_ALGO_LEAKY:
                out.append(None)
                continue
            remaining = int(ent[i, L_REMAINING])
            out.append((
                int(ent[i, L_LIMIT]),
                int(ent[i, L_DURATION]),
                remaining,
                int(self.clock.from_engine(np.int64(ent[i, L_EXPIRE]))),
                bool(flags & FLAG_STICKY_OVER) or remaining == 0,
            ))
        return out

    def live_mask(self, key_hash: np.ndarray, now: Optional[int] = None) -> np.ndarray:
        """bool[n]: the key holds a LIVE exact-tier entry (tag match, not
        expired). Non-mutating; the promoter screens candidates with it so
        an install never clobbers live exact state."""
        n = int(key_hash.shape[0])
        if n == 0 or self.clock.epoch is None:
            return np.zeros(n, bool)
        if now is None:
            now = api_types.millisecond_now()
        kh_p, _n = self._pad_keys_pow2(np.ascontiguousarray(key_hash, np.uint64))
        rows, fp = self._gather_entries(kh_p)
        e_now = int(self.clock.to_engine(now))
        live = (rows[:, :, L_TAG] == fp[:, None]) & (rows[:, :, L_EXPIRE] >= e_now)
        return live.any(axis=1)[:n]

    # -- full-store export / repartition ---------------------------------------

    def export_windows(self, now: Optional[int] = None) -> dict:
        """Host-side read of EVERY live window in the store, in store
        order: {key_hash uint64[m], limit, remaining, reset_time (unix-ms),
        is_over, duration, ts, flags}, the full-store twin of snapshot_read.
        Each entry's 64-bit key hash is rebuilt from its L_TAG|L_KEYLOW
        lanes; `is_over` is the FLAG_STICKY_OVER bit only (an exhausted
        but not sticky window must reinstall as exactly that), and the raw
        duration/ts/flags lanes ride along, so every algorithm's entry
        round-trips byte-exact through install_windows. `reset_time` is
        the L_EXPIRE lane in unix-ms, whatever the algorithm keeps there.
        The live mask runs on the device, so only live entries are copied
        off it (`last_export` records the ms and bytes). Non-mutating;
        runs on the batcher's submit thread (DeviceBatcher.run_serialized),
        so on a serving node the copy stalls the dispatches behind it."""
        empty = dict(
            key_hash=np.empty(0, np.uint64),
            limit=np.empty(0, np.int64),
            remaining=np.empty(0, np.int64),
            reset_time=np.empty(0, np.int64),
            is_over=np.empty(0, bool),
            duration=np.empty(0, np.int64),
            ts=np.empty(0, np.int64),
            flags=np.empty(0, np.int64),
        )
        if self.clock.epoch is None:
            return empty  # nothing ever decided
        if now is None:
            now = api_types.millisecond_now()
        e_now = int(self.clock.to_engine(now))
        t0 = time.perf_counter()
        lives = []
        for st in self._shard_stores():  # shard order, as the reference's
            ent = st.data.view(-1, LANES)
            live = (ent[:, L_TAG] != 0) & (ent[:, L_EXPIRE] >= e_now)
            lives.append(ent[live])  # the live count syncs with the device
        t1 = time.perf_counter()
        ent = np.concatenate([x.cpu().numpy() for x in lives])
        t2 = time.perf_counter()
        self.last_export = dict(
            ms=(t2 - t0) * 1e3,
            mask_ms=(t1 - t0) * 1e3,
            copy_ms=(t2 - t1) * 1e3,
            bytes=int(ent.nbytes),
            windows=int(ent.shape[0]),
        )
        if not ent.shape[0]:
            return empty
        mask = np.uint64(0xFFFFFFFF)
        hi = ent[:, L_TAG].astype(np.int64).view(np.uint64) & mask
        lo = ent[:, L_KEYLOW].astype(np.int64).view(np.uint64) & mask
        return dict(
            key_hash=(hi << np.uint64(32)) | lo,
            limit=ent[:, L_LIMIT].astype(np.int64),
            remaining=ent[:, L_REMAINING].astype(np.int64),
            reset_time=np.asarray(self.clock.from_engine(ent[:, L_EXPIRE]), np.int64),
            is_over=(ent[:, L_FLAGS] & FLAG_STICKY_OVER) != 0,
            duration=ent[:, L_DURATION].astype(np.int64),
            ts=ent[:, L_TS].astype(np.int64),
            flags=ent[:, L_FLAGS].astype(np.int64),
        )

    def repartition(
        self, policy: Optional[ShardingPolicy] = None, now: Optional[int] = None
    ) -> "TorchEngine":
        """A NEW engine under `policy` (the flat policy on this engine's
        device when None) with this one's geometry, ladder and sketch
        config, carrying every live window of this one (export_windows ->
        install_windows with the full lanes, routed by hash under the new
        policy): the store re-partition path a GUBER_SHARDS change drives,
        and a checkpoint restore across a shard-count change. A flat
        policy gives a TorchEngine (on `policy.device`, else this engine's
        device), a mesh policy a MeshEngine. Sketch counts do not migrate
        (window-keyed and transient, as in the reference). Call with the
        batcher idle or on its submit thread."""
        if now is None:
            now = api_types.millisecond_now()
        if policy is None or policy.flat:
            dev = self.device if policy is None or policy.device is None else policy.device
            eng = TorchEngine(
                self.config, buckets=self.buckets, device=dev, sketch=self.sketch_config,
                cuda_graphs=self.cuda_graphs,
            )
        else:
            eng = MeshEngine(
                self.config, buckets=self.buckets, sketch=self.sketch_config, policy=policy,
                cuda_graphs=self.cuda_graphs,
            )
        w = self.export_windows(now)
        if w["key_hash"].shape[0]:
            eng.install_windows(
                w["key_hash"], w["limit"], w["remaining"], w["reset_time"],
                w["is_over"], now=now, duration=w["duration"], ts=w["ts"],
                flags=w["flags"],
            )
        return eng

    # -- window install ------------------------------------------------------

    def install_windows(
        self,
        key_hash: np.ndarray,
        limit: np.ndarray,
        remaining: np.ndarray,
        reset_time: np.ndarray,
        is_over: np.ndarray,
        now: Optional[int] = None,
        duration: Optional[np.ndarray] = None,
        ts: Optional[np.ndarray] = None,
        flags: Optional[np.ndarray] = None,
    ) -> None:
        """Install windows for pre-hashed keys (reset_time in unix-ms):
        the GLOBAL replica install and the sketch promoter's migration
        surface. Batches past the ladder's top rung are CHUNKED, in order,
        so duplicates stay last-wins. Without `flags` the install is the
        token-replica form (zero duration/ts, sticky-only flags); with
        `duration`/`ts`/`flags` the raw lanes land verbatim and `is_over`
        is ignored. Each chunk is one upsert, one writeback launch."""
        kh = np.ascontiguousarray(key_hash, np.uint64)
        n = int(kh.shape[0])
        if n == 0:
            return
        if now is None:
            now = api_types.millisecond_now()
        self._engine_now(now)  # pin/refresh the epoch
        top = max(self.buckets)
        limit = np.asarray(limit)
        remaining = np.asarray(remaining)
        reset_time = np.asarray(reset_time)
        full = flags is not None
        if full:
            duration = np.asarray(duration)
            ts = np.zeros(n, np.int64) if ts is None else np.asarray(ts)
            flags = np.asarray(flags)
        else:
            is_over = np.asarray(is_over, bool)
        for s in range(0, n, top):
            e = min(s + top, n)
            self.install_chunks += 1
            head = (
                (kh[s:e], np.uint64),
                (_sat_i32(limit[s:e]), np.int32),
                (_sat_i32(remaining[s:e]), np.int32),
                (self.clock.to_engine(reset_time[s:e]), np.int32),
            )
            if full:
                cols = pad_to_bucket(
                    self.buckets, e - s, *head,
                    (_sat_i32(duration[s:e]), np.int32),
                    (_sat_i32(ts[s:e]), np.int32),
                    (_sat_i32(flags[s:e]), np.int32),
                )
            else:
                cols = pad_to_bucket(self.buckets, e - s, *head, (is_over[s:e], bool))
            self._install_chunk(cols, full)

    def _install_chunk(self, cols, full: bool) -> None:
        """One padded install: upsert_windows (`full`: key, limit,
        remaining, reset, duration, ts, flags, valid) or upsert_globals
        (key, limit, remaining, reset, is_over, valid) on every store,
        each keeping only the keys it owns (install_program a device: the
        reference's upsert_*_jit, on a mesh _shard_upsert[_full]). One
        writeback launch a store; on the card one replay a device of its
        (lanes, rung) graph."""
        B = cols[0].shape[0]
        layout = InstallLayout(B, full)
        for dev, g, stores, _sks, shards in self._device_shards():
            with _on(dev):
                g.run(("install_full" if full else "install", B),
                      lambda static: install_program(stores, shards, self.n,
                                                     layout.views(static), full),
                      (cols,), lambda: layout, launches=len(stores), first_use=full)

    def update_globals(self, *args, now: Optional[int] = None, **kw):
        """Install owner-broadcast GLOBAL statuses (the UpdatePeerGlobals
        receive path). Two call forms, one install path (install_windows):

        - object form: update_globals([(key, RateLimitResp), ...])
        - array form:  update_globals(key_hash=..., limit=...,
          remaining=..., reset_time=..., is_over=...), positional ndarrays
          accepted.
        """
        updates_kw = kw.pop("updates", None)
        if updates_kw is not None:
            if args or kw:
                raise TypeError("update_globals(updates=...) excludes other args")
            args = (updates_kw,)
        if kw or len(args) > 1 or (args and isinstance(args[0], np.ndarray)):
            names = ("key_hash", "limit", "remaining", "reset_time", "is_over")
            vals = dict(zip(names, args))
            vals.update(kw)
            return self.install_windows(
                vals["key_hash"], vals["limit"], vals["remaining"],
                vals["reset_time"], vals["is_over"], now=now,
            )
        from gubernator_tpu_torch.core.hashing import slot_hash_batch

        updates = list(args[0]) if args else []
        n = len(updates)
        if n == 0:
            return
        return self.install_windows(
            slot_hash_batch([k for k, _ in updates]),
            np.fromiter((s.limit for _, s in updates), np.int64, n),
            np.fromiter((s.remaining for _, s in updates), np.int64, n),
            np.fromiter((s.reset_time for _, s in updates), np.int64, n),
            np.fromiter(
                (s.status == api_types.Status.OVER_LIMIT for _, s in updates), bool, n
            ),
            now=now,
        )

    def apply_global_hits(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        now: int,
        algo: Optional[np.ndarray] = None,
    ):
        """Charge aggregated GLOBAL hits on their owner and return the
        post-charge windows (status, limit, remaining, reset_time unix-ms)
        in caller order. On one device the owner is this store, so it is
        one local decide per ladder-sized chunk. Gossip traffic must not
        heat the promoter's top-K or count as decide batches in
        EngineStats, so its chunks skip the observer and the stats. (The
        reference swaps both attributes out around the call instead; here
        a fetch thread may be adding an earlier batch to `stats` at the
        same time, so nothing is swapped.)"""
        n = key_hash.shape[0]
        if n == 0:
            z = np.empty(0, np.int64)
            return z, z, z, z
        if algo is None:
            algo = np.zeros(n, np.int32)
        top = max(self.buckets)
        cols = ([], [], [], [])
        for s in range(0, n, top):
            e = min(s + top, n)
            self.gossip_chunks += 1
            h = self.decide_submit(
                key_hash[s:e], hits[s:e], limit[s:e], duration[s:e],
                algo[s:e], np.zeros(e - s, bool), now, observe=False,
            )
            for c, v in zip(cols, self.decide_wait(h, count=False)):
                c.append(v)
        return tuple(c[0] if len(c) == 1 else np.concatenate(c) for c in cols)

    def sync_globals(
        self,
        key_hash: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        now: int,
        algo: Optional[np.ndarray] = None,
    ) -> None:
        """One gossip step for these GLOBAL keys: the owner peeks its
        authoritative status (hits=0) and every other shard installs it.
        On one device the owner is this store and there is no replica, so
        it is apply_global_hits with no hits. `algo` must carry each key's
        algorithm (default token bucket)."""
        n = key_hash.shape[0]
        if n:
            self.apply_global_hits(
                key_hash, np.zeros(n, np.int64), limit, duration, now, algo=algo
            )

    # -- sketch cold tier ----------------------------------------------------

    def _sketch_windows(self, durations: np.ndarray, now: int):
        """(window_id int64[n], window_end_unix int64[n]) of the current
        fixed windows of these durations."""
        e_now = int(self.clock.to_engine(now))
        wid = window_id_np(e_now, durations)
        d = np.maximum(np.asarray(durations, np.int64), 1)
        return wid, np.asarray(self.clock.from_engine((wid + 1) * d))

    def sketch_estimates(
        self, key_hash: np.ndarray, durations: np.ndarray, now: Optional[int] = None
    ) -> np.ndarray:
        """NON-MUTATING current-window count-min estimates int64[n] (0
        when the tier is off or nothing was ever decided), at the same
        indices the decide charges."""
        n = int(key_hash.shape[0])
        if self.sketch is None or self.clock.epoch is None or n == 0:
            return np.zeros(n, np.int64)
        if now is None:
            now = api_types.millisecond_now()
        kh, dur, _n = self._pad_keys_pow2(
            np.ascontiguousarray(key_hash, np.uint64), np.asarray(durations, np.int64)
        )
        wid, _ = self._sketch_windows(dur, now)
        idx = sketch_indices_np(kh, wid, self.sketch_config)
        return self._sketch_min(kh, idx).numpy().astype(np.int64)[:n]

    def _sketch_min(self, kh: np.ndarray, idx: np.ndarray) -> torch.Tensor:
        """The count-min read of sketch_estimates, on the host: each key's
        min over rows r of its owner's counters at idx[r] (int64[rows, n]
        indices; sketch_min_program a device, the parts' owner-masked
        sum; on the card one graph replay a device a pow2 rung, the sum
        copied to pinned host memory)."""
        B, rows = kh.shape[0], idx.shape[0]
        layout = ReadLayout(B, rows)
        parts = []
        for dev, g, _stores, sks, shards in self._device_shards():
            with _on(dev):
                parts.append(self._read(
                    g, ("sketch_min", B, rows),
                    lambda static: sketch_min_program(sks, shards, self.n,
                                                      *layout.views(static)),
                    (kh, idx), layout,
                ))
        return copy_to_host(self._psum(parts))

    def promote_from_sketch(
        self,
        key_hash: np.ndarray,
        limits: np.ndarray,
        durations: np.ndarray,
        now: Optional[int] = None,
    ):
        """Migrate hot sketch-tier keys into exact buckets: install a
        token window with remaining = max(limit - estimate, 0) and reset
        = the current window's end, skipping keys that hold a LIVE exact
        entry. Returns (installed bool[n], estimate int64[n], reset_unix
        int64[n], over bool[n])."""
        n = int(key_hash.shape[0])
        if n == 0 or self.sketch is None:
            z = np.zeros(n, np.int64)
            return np.zeros(n, bool), z, z, np.zeros(n, bool)
        if now is None:
            now = api_types.millisecond_now()
        self._engine_now(now)  # pin the epoch before window math
        kh = np.ascontiguousarray(key_hash, np.uint64)
        limits = np.asarray(limits, np.int64)
        est = self.sketch_estimates(kh, durations, now)
        _, reset_unix = self._sketch_windows(durations, now)
        over = est >= limits
        remaining = np.maximum(limits - est, 0)
        todo = ~self.live_mask(kh, now)
        if todo.any():
            self.install_windows(
                kh[todo], limits[todo], remaining[todo], reset_unix[todo],
                over[todo], now,
            )
        return todo, est, reset_unix, over

    # -- warmup --------------------------------------------------------------

    def _warmup_sketch_reads(self, now: int) -> None:
        """Run the promoter's host reads at their pow2 rungs once."""
        if self.sketch is None:
            return
        for B in READ_RUNGS:
            kh = np.arange(1, B + 1, dtype=np.uint64) << np.uint64(32)
            self.sketch_estimates(kh, np.full(B, 1000, np.int64), now)
            self.live_mask(kh, now)

    def warmup(self, now: Optional[int] = None) -> None:
        """Decide once at every (request rung b, group rung g) pair, as
        the reference's warmup compiles one program a pair: batches of b
        rows over g distinct fingerprints, with the exact program and,
        when a sketch is configured, the two-tier one too (`sketch_on`
        flips at run time). On a GPU each such decide captures its CUDA
        graph (`graph_count` pairs x programs; `capture_s` the seconds of
        every capture, `program_capture_s` of the non-decide ones). One
        token window install a ladder rung, and the sketch reads at
        READ_RUNGS, each capturing its graph too, so that none of it
        lands inside a serving deadline; then wipe the state and counters
        the warmup traffic dirtied. The chain program and the full-lane
        install are captured on first use (the reference's warmup does
        not compile them either)."""
        if now is None:
            now = api_types.millisecond_now()
        sketch_on = self.sketch_on
        tiers = (False, True) if self.sketch is not None else (False,)
        try:
            for b in self.buckets:
                ones = np.ones(b, np.int64)
                for g in group_rungs(b):
                    k = np.resize(np.arange(1, g + 1, dtype=np.uint64) << np.uint64(32), b)
                    for on in tiers:
                        self.sketch_on = on
                        self.decide_arrays(
                            k, ones, ones * 10, ones * 1000,
                            np.zeros(b, np.int32), np.zeros(b, bool), now,
                        )
                k = np.arange(1, b + 1, dtype=np.uint64) << np.uint64(32)
                self.install_windows(k, ones, ones, ones * now, np.zeros(b, bool), now)
        finally:
            self.sketch_on = sketch_on
        self._warmup_sketch_reads(now)
        if self.device.type == "cuda":
            synchronize(self.device)
        # the writebacks this warmup made on a GPU (one a decide, each a
        # capture's eager run or a replay, and one an install chunk),
        # before its counters are zeroed
        self.warmup_launches = self.stats.batches + self.install_chunks + self.gossip_chunks
        self.reset()
        self.stats = EngineStats()
        self.install_chunks = self.gossip_chunks = 0
        self._graphs_warmed()


# -- the mesh policy -----------------------------------------------------------


def _on(device: torch.device):
    """The device guard of a per-shard step: a launch through ctypes (the
    writeback kernel) and every allocation land on the shard's own GPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _row(batch, s: int):
    """Shard s's sub-batch: row s of every [n_shards, ...] field."""
    return type(batch)(*(x[s] for x in batch))


def _rows(batch, rows: slice):
    """Rows `rows` of every [n_shards, ...] field (the shards this process
    holds)."""
    return type(batch)(*(x[rows] for x in batch))


def _hier_psum(parts: Sequence[torch.Tensor], policy: ShardingPolicy,
               leader: torch.device) -> torch.Tensor:
    """The reference's psum over the shard axis, in one process: the sum
    of the parts of the distinct devices of `policy.devices` (in order
    of first appearance; each already its shards' sum), on `leader`. On
    a 2-D ("host", "chip") policy each host's devices combine first (on
    the host's first device), then the hosts: the reference's
    hierarchical staging. Elementwise adds of one dtype, so int32 wraps
    as psum does (a torch.sum would widen to int64), in any order."""

    def add(xs, dev):
        with _on(dev):
            acc = xs[0].to(dev)
            for x in xs[1:]:
                acc = acc + x.to(dev)
        return acc

    left = dict(zip(dict.fromkeys(policy.devices), parts))
    partial = []
    for grp in policy.host_groups():
        devs = [policy.devices[s] for s in grp]
        xs = [left.pop(d) for d in dict.fromkeys(devs) if d in left]
        if xs:
            partial.append(add(xs, devs[0]))
    return add(partial, leader)


class MeshEngine(TorchEngine):
    """Key-space sharding over a list of devices (the reference's
    MeshEngine, PartitionedEngine under ShardingPolicy.over_mesh), in one
    process. Shard s owns the keys with owner_of(key) == s: its slot
    store (and sub-sketch) live on devices[s]; a batch is presorted by
    (owner, bucket, fingerprint) and split into [n_shards, B_sub]
    sub-batches, and every shard runs the single-device decide on its own
    sub-batch (every shard runs every batch, as shard_map does). The
    cross-shard steps (GLOBAL sync, the promoter's reads) are owner-masked
    sums on the leader, devices[0] (_psum). A device may repeat: on one
    GPU or the CPU, N shards share it.

    Each shard's writeback is one launch, so on a GPU a decide, an install
    chunk and a gossip chunk launch `n_local` writebacks each, and a GLOBAL
    sync step counts one gossip chunk (the owner charge) and one install
    chunk (the replica install).

    On a GPU the decide is captured (core/graphs.py): one DeviceGraphs a
    distinct device (`device_graphs`), whose graph for a (program,
    B_sub, G_sub) decides every local shard on that device in shard
    order, so a batch is one staged upload and one replay a device, the
    counterpart of the reference's one jitted shard_map program over
    every shard. So are the collectives: an install chunk, a GLOBAL step
    and a read are one program a device over its shards, each masked by
    owner (install_program, sync_charge_program / sync_install_program,
    rows_program, sketch_min_program), with the devices' parts summed
    between runs (`_sync_step`, `_psum`). `warmup` captures every decide
    pair, the token install and GLOBAL step at every host rung and the
    reads at READ_RUNGS; the chain program, the full-lane install and
    other read rungs capture on first use. `cuda_graphs=False` (the A/B
    leg and the card tests; no serving path) and the CPU run the same
    programs eagerly, a device at a time (EagerPrograms), and the decide
    a shard at a time.

    Under a policy that spans processes (ShardingPolicy.over_processes)
    `n` is the GLOBAL shard count and this process holds the shards
    `policy.local_shards` on `devices`: it decides its rows of every
    batch, posts the gather of its packed rows to process 0 at submit
    (decide_wait on process 0 waits on it), and every owner-masked sum
    ends in one all_reduce across processes (_psum). Every process must
    run the same steps in the same order (parallel/multihost.py).
    `collective_stats` counts those collectives and the ms spent in
    them: the gathers the leader waited on, and each all_reduce."""

    def __init__(
        self,
        config: StoreConfig = StoreConfig(),
        devices: Optional[Sequence[DeviceLike]] = None,
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        mesh_shape: Optional[Tuple[int, int]] = None,
        sketch: Optional[SketchConfig] = None,
        policy: Optional[ShardingPolicy] = None,
        cuda_graphs: bool = True,
    ):
        self._init_host(config, buckets, sketch)
        self.policy = (
            policy if policy is not None else ShardingPolicy.over_mesh(devices, mesh_shape)
        )
        if self.policy.flat:
            raise ValueError("MeshEngine needs a mesh policy; the flat one is TorchEngine's")
        self.devices = self.policy.devices
        self.n = self.policy.n_shards
        local = self.policy.local_shards
        self._local = slice(local.start, local.stop)
        self.collective_stats = dict(gathers=0, gather_wait_ms=0.0,
                                     all_reduces=0, all_reduce_ms=0.0)
        self._collective_lock = threading.Lock()
        self.axes = self.policy.axes
        self.device = self.devices[0]  # the leader: host reads combine here
        self.sub_buckets = sub_batch_ladder(self.buckets)
        self.stores = [new_store(config, d) for d in self.devices]
        self.sketches = (
            None if sketch is None else [new_sketch(sketch, d) for d in self.devices]
        )
        # the tier gate every shared surface reads (None: exact only)
        self.sketch = self.sketches
        # each distinct device's local shards, in shard order, and the
        # index that takes their rows of a [n_local, ...] array (a slice
        # when they are contiguous)
        shards_of: dict = {}
        for s, dev in enumerate(self.devices):
            shards_of.setdefault(dev, []).append(s)
        self._device_rows = {
            dev: (rows, slice(rows[0], rows[-1] + 1) if rows[-1] - rows[0] == len(rows) - 1
                  else rows)
            for dev, rows in shards_of.items()
        }
        self.cuda_graphs = cuda_graphs
        self._new_graphs()

    def _new_graphs(self) -> None:
        self._warmed = False
        self.device_graphs = {}
        if self.cuda_graphs and self.device.type == "cuda":
            top = max(self.sub_buckets)
            for dev, (rows, _idx) in self._device_rows.items():
                self.device_graphs[dev] = DeviceGraphs(
                    dev, self._staging_bytes(top, len(rows)), len(rows))

    def _device_shards(self):
        for dev, (rows, _idx) in self._device_rows.items():
            g = self.device_graphs[dev] if self.device_graphs else EagerPrograms(dev)
            yield (dev, g, [self.stores[s] for s in rows],
                   None if self.sketches is None else [self.sketches[s] for s in rows],
                   [self._local.start + s for s in rows])

    def _graph_sets(self) -> list:
        return list(self.device_graphs.values())

    def _shard_stores(self) -> list:
        return self.stores

    def _shard_sketches(self) -> list:
        return self.sketches or []

    def _state_lead(self) -> tuple:
        return (len(self.devices),)

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def _per_device(self, fn):
        """fn(device) once per distinct device, as {device: result}: a
        batch goes up to each device once and its shards take row views."""
        out = {}
        for dev in self.devices:
            if dev not in out:
                with _on(dev):
                    out[dev] = fn(dev)
        return out

    # -- decide ----------------------------------------------------------------

    def _dispatch(self, req, groups, e_now, observe: bool = True, chain_id=None):
        """The mesh's dispatch funnel: feed the observer the numpy
        [n_shards, B_sub] batch (it masks by `valid`) and decide this
        process's rows of it, each shard on its own store (and
        sub-sketch) and row. With graphs, each device's rows go up in one
        staged upload and are decided by one replay; eagerly, the rows go
        up once a device and each shard runs its decide. Returns (blocks:
        (the index of their local shards, a slice or a list; their packed
        outputs [k, 4*B_sub+4]) in shard order, {device: CUDA event
        recorded before its upload})."""
        self._observe(req, groups, observe)
        t0 = time.monotonic()
        starts = {}
        req, groups = _rows(req, self._local), _rows(groups, self._local)
        if chain_id is not None:
            chain_id = chain_id[self._local]
        two_tier = self.sketches is not None and self.sketch_on
        if self.device_graphs:
            program = "chain" if chain_id is not None else "sketch" if two_tier else "exact"
            blocks = []
            for dev, (rows, idx) in self._device_rows.items():
                with _on(dev):
                    starts[dev] = torch.cuda.Event(enable_timing=True)
                    starts[dev].record()
                    out = self.device_graphs[dev].decide(
                        program, [self.stores[s] for s in rows],
                        [self.sketches[s] if two_tier else None for s in rows],
                        _rows(req, idx), _rows(groups, idx), e_now,
                        None if chain_id is None else chain_id[idx],
                    )
                blocks.append((idx, out))
            self._span("launch", t0)
            return blocks, starts

        def upload(dev):
            if dev.type == "cuda":
                starts[dev] = torch.cuda.Event(enable_timing=True)
                starts[dev].record()
            chain_t = None if chain_id is None else torch.from_numpy(chain_id).to(dev)
            return to_device(req, dev), to_device(groups, dev), chain_t

        up = self._per_device(upload)
        blocks = []
        for s, dev in enumerate(self.devices):
            req_t, groups_t, chain_t = up[dev]
            with _on(dev):
                r, g = _row(req_t, s), _row(groups_t, s)
                if chain_t is not None:
                    _st, p = decide_packed_chain(self.stores[s], r, e_now, g, chain_t[s])
                elif two_tier:
                    _st, _sk, p = decide_packed_sketch(
                        self.stores[s], self.sketches[s], r, e_now, g
                    )
                else:
                    _st, p = decide_packed(self.stores[s], r, e_now, g)
            blocks.append((slice(s, s + 1), p[None]))
        self._span("launch", t0)
        return blocks, starts

    def _mesh_handle(self, blocks, starts, order, take_idx, n: int, B_sub: int):
        """decide_wait's handle: (packed host int32[n_shards, 4*B_sub+4],
        {device: event after its last copy}, {device: start event}, order,
        take_idx, n, B_sub, epoch, the gather's Work or None). On CUDA each
        block of shard rows starts copying into one pinned host array at
        once (one copy a device when its shards are contiguous). On a mesh
        that spans processes the first item is, on process 0, the list of
        every process's rows that the posted gather fills."""
        t0 = time.monotonic()
        ends = {}
        if self.devices[0].type == "cuda":
            host = torch.empty((len(self.devices), blocks[0][1].shape[1]), dtype=torch.int32,
                               pin_memory=True)
            for idx, block in blocks:
                with _on(block.device):
                    if isinstance(idx, slice):
                        host[idx].copy_(block, non_blocking=True)
                    else:
                        for j, s in enumerate(idx):
                            host[s].copy_(block[j], non_blocking=True)
                    ends[block.device] = torch.cuda.Event(enable_timing=True)
                    ends[block.device].record()
        else:
            host = torch.cat([block for _idx, block in blocks])
        work = None
        if self.policy.spans_processes:
            host, work = self._post_gather(host, ends)
        self._span("readback", t0)
        return host, ends, starts, order, take_idx, n, B_sub, self.clock.epoch, work

    def _post_gather(self, rows: torch.Tensor, ends: dict):
        """Post the gather of this process's packed rows to process 0,
        without waiting on it. gloo reads `rows` from its own thread, so
        the card must have written them first: the copies' events are
        waited on here. Returns (process 0's list of every process's
        rows, else `rows`; the Work)."""
        import torch.distributed as dist

        for ev in ends.values():
            ev.synchronize()
        out = None
        if self.policy.process_index == 0:
            out = [torch.empty_like(rows) for _ in range(self.policy.process_count)]
        work = dist.gather(rows, out, dst=0, async_op=True)
        return (rows if out is None else out), work

    def _count_collective(self, kind: str, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        with self._collective_lock:
            if kind == "gather":
                self.collective_stats["gathers"] += 1
                self.collective_stats["gather_wait_ms"] += ms
            else:
                self.collective_stats["all_reduces"] += 1
                self.collective_stats["all_reduce_ms"] += ms

    def _psum(self, parts: list) -> torch.Tensor:
        """The owner-masked sum of the devices' parts (one a distinct
        device, in `_device_shards` order, each its shards' masked parts
        summed by their program): _hier_psum onto the leader, then, on a
        mesh that spans processes, one all_reduce(SUM) of that
        pre-reduced tensor across processes, staged through pinned host
        memory (gloo), whose result stays on the host. Elementwise in the
        dtype, so int32 wraps as psum does."""
        total = _hier_psum(parts, self.policy, self.device)
        if not self.policy.spans_processes:
            return total
        import torch.distributed as dist

        t0 = time.perf_counter()
        if total.is_cuda:
            host = torch.empty(total.shape, dtype=total.dtype, pin_memory=True)
            host.copy_(total, non_blocking=True)
            # gloo reads the buffer from its own thread
            torch.cuda.current_stream(total.device).synchronize()
            total = host
        dist.all_reduce(total)  # a fresh sum or its copy: nothing else holds it
        self._count_collective("all_reduce", t0)
        return total

    def decide_submit(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        gnp: np.ndarray,
        now: int,
        observe: bool = True,
    ):
        """Shard + dispatch one batch WITHOUT waiting (the handle captures
        the submit-time epoch)."""
        n = key_hash.shape[0]
        e_now = self._engine_now(now)
        req, order, take_idx, groups = pad_request_sharded(
            self.sub_buckets, self.config.slots, self.n, key_hash, hits,
            limit, duration, algo, gnp, with_groups=True,
        )
        blocks, starts = self._dispatch(req, groups, e_now, observe)
        # the native prep's order/take_idx are views into a buffer ring
        # that a handle can outlive under the batcher's fetch pipeline
        return self._mesh_handle(
            blocks, starts, np.array(order), np.array(take_idx), n,
            req.key_hash.shape[1],
        )

    def prep_run(self, fields: dict) -> dict:
        """Arrival-time prep of one caller group, sorted by (owner,
        bucket, fingerprint) so runs merge without re-sorting."""
        return prep_run_sharded(fields, self.config.slots, self.n)

    def merge_prepped(self, runs) -> dict:
        """Merge pre-sorted runs into one dispatch-ready sharded batch."""
        from gubernator_tpu_torch.serve.prep import merge_runs

        m = merge_runs(runs)
        req, take_idx, groups, B_sub = build_presorted_sharded(
            self.sub_buckets, self.config.slots, self.n, m["fields"], m["skey"],
            m["counts"],
        )
        return dict(req=req, groups=groups, order=m["order"], take_idx=take_idx,
                    n=m["order"].shape[0], B_sub=B_sub)

    def decide_submit_merged(self, merged: dict, now: int):
        e_now = self._engine_now(now)
        blocks, starts = self._dispatch(merged["req"], merged["groups"], e_now)
        return self._mesh_handle(blocks, starts, merged["order"], merged["take_idx"],
                                 merged["n"], merged["B_sub"])

    def decide_submit_presorted(
        self,
        fields: dict,
        skey: np.ndarray,
        order: Optional[np.ndarray],
        counts: np.ndarray,
        now: int,
    ):
        """Dispatch a batch presorted by (owner, bucket, fingerprint):
        `counts` are its per-shard row counts."""
        n = skey.shape[0]
        if n == 0:
            return None
        e_now = self._engine_now(now)
        req, take_idx, groups, B_sub = build_presorted_sharded(
            self.sub_buckets, self.config.slots, self.n, fields, skey, counts,
        )
        if order is None:
            order = np.arange(n, dtype=np.int32)
        blocks, starts = self._dispatch(req, groups, e_now)
        return self._mesh_handle(blocks, starts, order, take_idx, n, B_sub)

    def decide_wait(
        self, handle, count: bool = True
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fetch + unpermute one sharded batch: (status, limit, remaining,
        reset_time int64 unix-ms) in caller order. Waits on this batch's
        own copy events; the stats land once for the batch, summed over
        its shards."""
        host, ends, starts, order, take_idx, n, B_sub, epoch, work = handle
        t_sync = time.monotonic()
        for ev in ends.values():
            ev.synchronize()
        if count and ends:
            self.device_span_ms += max(starts[d].elapsed_time(ends[d]) for d in ends)
        if work is not None:
            t0 = time.perf_counter()
            work.wait()
            self._count_collective("gather", t0)
            host = torch.cat(host)
        self._span("fetch_sync", t_sync)
        t_unpack = time.monotonic()
        packed = host.numpy()
        if count:
            self.stats.add_batch(
                int(packed[:, 4 * B_sub].sum()),
                int(packed[:, 4 * B_sub + 1].sum()),
                int(packed[:, 4 * B_sub + 2].sum()),
                int(packed[:, 4 * B_sub + 3].sum()),
            )
        hn = _native()
        if hn is not None and n > 0:
            # one native pass over the four response columns
            bounds = np.searchsorted(take_idx, np.arange(1, self.n + 1) * B_sub, side="left")
            counts = np.diff(np.concatenate(([0], bounds))).astype(np.int64)
            status, rlimit, remaining, reset = hn.unflatten_resp(
                packed, order, counts, n, B_sub
            )
        else:
            def unflatten(col):
                flat = packed[:, col * B_sub : (col + 1) * B_sub].reshape(-1)
                out = np.empty(n, flat.dtype)
                out[order] = flat[take_idx]
                return out

            status, rlimit, remaining, reset = (unflatten(c) for c in range(4))
        r = np.asarray(reset, np.int64)
        self._span("unpack", t_unpack)
        return status, rlimit, remaining, np.where(r == 0, 0, r + epoch)

    def decide_chain_submit(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        chain_ids: np.ndarray,
        route_hash: np.ndarray,
        now: int,
    ):
        """Dispatch one CHAINED batch without waiting: each chain goes
        whole to its head's owner (`route_hash`), so the no-partial-debit
        reduction stays shard-local. Exact-only; the handle is
        decide_wait's. Refused on a mesh that spans processes: the step
        pipe has no chain message."""
        if self.policy.spans_processes:
            raise ValueError(
                "quota chains are not supported on the multihost "
                "lockstep engine (no chain step message); route chains "
                "to single-host backends"
            )
        n = key_hash.shape[0]
        e_now = self._engine_now(now)
        req, order, take_idx, groups, chain_local = pad_request_chained(
            self.sub_buckets, self.config.slots, self.n, key_hash, hits, limit,
            duration, algo, chain_ids, route_hash,
        )
        if self.n == 1:  # the flat layout: one shard holds the batch
            req = BatchRequest(*(x[None] for x in req))
            groups = BatchGroups(*(x[None] for x in groups))
            chain_local = chain_local[None]
            take_idx = np.arange(n, dtype=np.int64)
        blocks, starts = self._dispatch(req, groups, e_now, chain_id=chain_local)
        return self._mesh_handle(blocks, starts, order, take_idx, n, req.key_hash.shape[1])

    # -- the GLOBAL sync ------------------------------------------------------

    def _sync_padded(self, key_hash, hits, limit, duration, algo, now):
        """One owner-charge + combine + replica-install step (the
        reference's _shard_sync_globals): each shard charges `hits` on the
        keys it owns (hits 0: a peek) and keeps its answers for them, the
        owner-masked sum on the leader gives every key its owner's
        post-charge window, and every other shard installs it as a
        replica. Returns the int32[4, B] (status, limit, remaining, reset)
        in the padded sorted order, and that order. Neither the observer nor the
        stats see it (gossip is not traffic)."""
        n = key_hash.shape[0]
        if algo is None:
            algo = np.zeros(n, np.int32)
        e_now = self._engine_now(now)
        if n > max(self.buckets):
            _warn_ladder_overflow(max(self.buckets), n)
        req, order = pad_request_sorted(
            extend_ladder(self.buckets, n), self.config.slots, key_hash, hits,
            limit, duration, algo, np.zeros(n, bool),
        )
        self.gossip_chunks += 1  # the owner charge: one writeback a shard
        self.install_chunks += 1  # the replica install: one a shard
        return self._sync_step(req, e_now), order

    def _sync_step(self, req: BatchRequest, e_now) -> torch.Tensor:
        """`_sync_padded`'s step: the summed int32[4, B] answers (on the
        leader, or on the host across processes). On one device in one
        process the charge, the sum and the install are one program
        ("sync"); otherwise each device runs its charge program, the
        parts are summed (and all_reduced across processes) between the
        runs, and each device runs its install program, which reads the
        sum fed to it and the request from the charge's input. On the
        card each program is a graph replay."""
        B = req.key_hash.shape[0]
        layout = RequestLayout(B)
        devices = list(self._device_shards())
        if len(devices) == 1 and not self.policy.spans_processes:
            dev, g, stores, _sks, shards = devices[0]

            def fused(static):
                r, now = layout.views(static)
                total = self._psum([sync_charge_program(stores, shards, self.n, r, now)])
                sync_install_program(stores, shards, self.n, r, total)
                return total

            with _on(dev):
                return g.run(("sync", B), fused, (req, e_now), lambda: layout,
                             launches=2 * len(shards))
        parts = []
        for dev, g, stores, _sks, shards in devices:
            with _on(dev):
                parts.append(g.run(
                    ("sync_charge", B),
                    lambda static: sync_charge_program(stores, shards, self.n,
                                                       *layout.views(static)),
                    (req, e_now), lambda: layout, launches=len(shards)))
        total = self._psum(parts)
        for dev, g, stores, _sks, shards in devices:
            charged, static = g.inputs(("sync_charge", B))
            with _on(dev):
                g.run(("sync_install", B),
                      lambda t: sync_install_program(
                          stores, shards, self.n, charged.views(static)[0], t),
                      feed=total, launches=len(shards))
        return total

    def sync_globals(
        self,
        key_hash: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        now: int,
        algo: Optional[np.ndarray] = None,
    ) -> None:
        """One gossip step for these GLOBAL keys: owners peek their
        authoritative status (hits=0) and every other shard installs it.
        `algo` must carry each key's algorithm (default token bucket)."""
        n = key_hash.shape[0]
        if n:
            self._sync_padded(key_hash, np.zeros(n, np.int64), limit, duration, algo, now)

    def apply_global_hits(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        now: int,
        algo: Optional[np.ndarray] = None,
    ):
        """Charge aggregated GLOBAL hits on each key's owner shard and
        install the post-charge window on every other shard, in one step
        (the owner -> replica gossip collapsed). Returns (status, limit,
        remaining, reset_time unix-ms) in caller order."""
        n = key_hash.shape[0]
        if n == 0:
            z = np.empty(0, np.int64)
            return z, z, z, z
        resp, order = self._sync_padded(key_hash, hits, limit, duration, algo, now)
        epoch = self.clock.epoch
        resp = copy_to_host(resp).numpy()  # the four columns in one copy

        def unpad(a):
            out = np.empty(a.shape[0], a.dtype)
            out[order] = a
            return out[:n]

        status, rlimit, remaining, reset = (unpad(a) for a in resp)
        r = reset.astype(np.int64)
        return status, rlimit, remaining, np.where(r == 0, 0, r + epoch)

    # -- warmup --------------------------------------------------------------

    def warmup(self, now: Optional[int] = None) -> None:
        warmup_public(self, now)


def warmup_public(engine: MeshEngine, now: Optional[int] = None) -> None:
    """Mesh warmup through the engine's public surface, as the
    reference's warmup_public walks it: one decide at every (sub-batch
    rung r, group rung g in group_rungs(r)) pair, crafted so every shard
    holds r rows over g distinct keys (`np.resize(p[:g], r)` of its own
    keys), with the exact program and, when a sketch is configured, the
    two-tier one too (`sketch_on` flips at run time); on a GPU each
    captures that pair's graph on every device. Then one replica install
    and one GLOBAL sync a host rung, and the sketch reads at READ_RUNGS
    (on a GPU each capturing its graphs on every device), then wipe
    the state and zero the counters the warmup dirtied. `warmup_launches`
    keeps the writebacks it made on a GPU: n_shards x (decides + install
    chunks + gossip chunks), n_shards being this process's. Driving only
    the public surface keeps it lockstep-safe for the multihost wrapper:
    every process walks, and captures, the same shapes in one order."""
    if now is None:
        now = api_types.millisecond_now()
    n = engine.n
    rungs = engine.sub_buckets
    rng = np.random.default_rng(0xB007)
    pool = rng.integers(1, 2**63, 4 * n * max(rungs), np.int64).astype(np.uint64)
    owners = owner_of_np(pool, n)
    per_shard = [pool[owners == s] for s in range(n)]
    sketch_on = engine.sketch_on
    tiers = (False, True) if engine.sketch is not None else (False,)
    try:
        for r in rungs:
            for g in group_rungs(r):
                k = np.concatenate([np.resize(p[:g], r) for p in per_shard])
                ones = np.ones(k.shape[0], np.int64)
                for on in tiers:
                    engine.sketch_on = on
                    engine.decide_arrays(
                        k, ones, ones * 10, ones * 1000, np.zeros(k.shape[0], np.int32),
                        np.zeros(k.shape[0], bool), now,
                    )
    finally:
        engine.sketch_on = sketch_on
    for b in engine.buckets:
        k = np.arange(1, b + 1, dtype=np.uint64) << np.uint64(32)
        ones = np.ones(b, np.int64)
        engine.update_globals(
            key_hash=k, limit=ones, remaining=ones, reset_time=ones * now,
            is_over=np.zeros(b, bool), now=now,
        )
        engine.sync_globals(k, ones, ones * 1000, now=now)
    engine._warmup_sketch_reads(now)
    for dev in dict.fromkeys(engine.devices):
        if dev.type == "cuda":
            synchronize(dev)
    engine.warmup_launches = engine.n_local * (
        engine.stats.batches + engine.install_chunks + engine.gossip_chunks
    )
    engine.reset()
    engine.stats = EngineStats()
    engine.install_chunks = engine.gossip_chunks = 0
    engine._graphs_warmed()
