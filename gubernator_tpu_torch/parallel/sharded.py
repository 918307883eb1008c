"""TorchEngine: the single-device engine (PyTorch port of the flat half
of gubernator_tpu.parallel.sharded.PartitionedEngine).

Host glue + the decide for a slot store resident on one device, with or
without the count-min cold tier: presort and pad each batch on the host
(core.engine; the merge of prepped runs and the responses' unpermute
run in the native prep library when it loads, as the reference's do,
numpy otherwise), copy the padded arrays to the device, run the exact-tier
or two-tier decide (which update the store and sketch tensors in place;
JAX donates them instead), and fetch ONE packed int32 array of
responses + stats per batch.

Ported surfaces: construction (optionally with a SketchConfig), reset
(bumping `reset_generation`, the shed cache's store-wipe epoch) and the
epoch clock with its store rebase (both clear the sketch), the
request-object API (get_rate_limits[_submit/_wait]), the array API
(decide_submit / decide_wait / decide_arrays), the arrival-prep path
(prep_run / merge_prepped / decide_submit_merged /
decide_submit_presorted), the GLOBAL surfaces (update_globals in both
call forms, apply_global_hits), the promoter's engine surfaces
(observe_hook, sketch_estimates, live_mask, snapshot_read,
install_windows, promote_from_sketch), warmup, and load_state, which
carries a JAX engine's store, sketch and clock across. Not ported yet:
the mesh policy and quota chains.

Every submit path ends in `_dispatch`, which feeds `observe_hook` the
host-side numpy BatchRequest and runs the decide; on a CUDA device the
submit then starts a non-blocking copy of the packed outputs into pinned
host memory and records an event, so `decide_wait` waits for its own
batch only, never for batches submitted after it.

Thread model (the reference's): submits are serialized on one thread;
decide_wait calls may run concurrently on fetch threads, touching only
their own handle and the stats, which land under EngineStats' lock.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.core.engine import (
    EngineStats,
    EpochClock,
    _native,
    _sat_i32,
    build_presorted_request,
    choose_bucket,
    group_rungs,
    decide_packed,
    decide_packed_sketch,
    pad_request_sorted,
    pad_to_bucket,
    prep_run_single,
    to_device,
    unpermute_responses,
)
from gubernator_tpu_torch.core.kernels import (
    BatchGroups,
    BatchRequest,
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
    FLAG_ALGO_LEAKY,
    FLAG_STICKY_OVER,
    L_DURATION,
    L_EXPIRE,
    L_FLAGS,
    L_LIMIT,
    L_REMAINING,
    L_TAG,
    LANES,
    DeviceLike,
    StoreConfig,
    bucket_index,
    fingerprints,
    key_hash_tensor,
    new_store,
    rebase,
    resolve_device,
)


class TorchEngine:
    """Single-device engine over a slot store on `device` (cuda unless
    the caller passes another; see core.store.resolve_device), with the
    count-min cold tier beside it when `sketch` is a SketchConfig."""

    def __init__(
        self,
        config: StoreConfig = StoreConfig(),
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        device: DeviceLike = None,
        sketch: Optional[SketchConfig] = None,
    ):
        self.config = config
        self.buckets = sorted(buckets)
        self.device = resolve_device(device)
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
        self.store = new_store(config, self.device)
        # `sketch_on` flips between the two-tier and the exact-only
        # decide at run time (the reference's A/B flag)
        self.sketch_config = sketch
        self.sketch = None if sketch is None else new_sketch(sketch, self.device)
        self.sketch_on = sketch is not None

    def reset(self) -> None:
        """Wipe the store and the sketch in place (the clock keeps its
        epoch)."""
        self.store.data.zero_()
        if self.sketch is not None:
            self.sketch.data.zero_()
        self.reset_generation += 1

    def _engine_now(self, now: int) -> np.int32:
        e, delta, reset_required = self.clock.advance(now)
        if reset_required:
            self.reset()
        elif delta is not None:
            rebase(self.store, delta)
            if self.sketch is not None:
                # sketch windows are keyed by engine-ms // duration: a
                # rebase moves every window id, so the counts are cleared
                self.sketch.data.zero_()
        return e

    def load_state(
        self,
        store_np: np.ndarray,
        epoch: Optional[int],
        sketch_np: Optional[np.ndarray] = None,
    ) -> None:
        """Carry another engine's state across: the int32[buckets, W]
        store bytes (e.g. a JAX TpuEngine's `np.asarray(store.data)`),
        its clock epoch (`clock.epoch`) and, for a two-tier engine, its
        sketch counters (`np.asarray(sketch.data)`, int32 or int64
        [rows, width]); a two-tier engine given no sketch starts with an
        empty one."""
        want = tuple(self.store.data.shape)
        if store_np.dtype != np.int32 or tuple(store_np.shape) != want:
            raise ValueError(
                f"store {store_np.dtype}{list(store_np.shape)} does not "
                f"match this engine's int32{list(want)}"
            )
        if sketch_np is not None:
            if self.sketch is None:
                raise ValueError("this engine has no sketch tier to load into")
            sk = self.sketch.data
            want_dtype = np.int32 if sk.dtype == torch.int32 else np.int64
            if sketch_np.dtype != want_dtype or tuple(sketch_np.shape) != tuple(sk.shape):
                raise ValueError(
                    f"sketch {sketch_np.dtype}{list(sketch_np.shape)} does not "
                    f"match this engine's {sk.dtype}{list(sk.shape)}"
                )
        arr = np.require(store_np, requirements=["C", "W"])
        self.store.data.copy_(torch.from_numpy(arr))
        if self.sketch is not None:
            if sketch_np is None:
                self.sketch.data.zero_()
            else:
                sk_arr = np.require(sketch_np, requirements=["C", "W"])
                self.sketch.data.copy_(torch.from_numpy(sk_arr))
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

    def _dispatch(self, req, groups, e_now, observe: bool = True):
        """The one dispatch funnel of every submit path: feed the hot-key
        observer the numpy batch (unless `observe` is False), copy it to
        the device and run the exact-only or the two-tier decide there;
        returns (the packed output tensor, the CUDA event recorded before
        the upload, or None off the card)."""
        hook = self.observe_hook if observe else None
        if hook is not None:
            try:
                hook(req)
            except Exception:  # pragma: no cover - defensive
                pass  # observability must never fail a dispatch
        start = None
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        req_t = to_device(req, self.device)
        groups_t = to_device(groups, self.device)
        if self.sketch is not None and self.sketch_on:
            _store, _sketch, packed = decide_packed_sketch(
                self.store, self.sketch, req_t, e_now, groups_t
            )
            return packed, start
        _store, packed = decide_packed(self.store, req_t, e_now, groups_t)
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
        event = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            packed = host
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
        if event is not None:
            event.synchronize()
            if count and start is not None:
                self.device_span_ms += start.elapsed_time(event)
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
        key's bucket row and tag, gathered on the device. The one lookup
        snapshot_read and live_mask share."""
        kh = key_hash_tensor(kh_padded, self.device)
        rows = self.store.data.index_select(0, bucket_index(kh, self.config.slots))
        return (
            rows.cpu().numpy().reshape(kh_padded.shape[0], -1, LANES),
            fingerprints(kh).cpu().numpy(),
        )

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
                kh_t, *rest = self._cols_to_device(cols)
                upsert_windows(self.store, kh_t, *rest)
            else:
                cols = pad_to_bucket(self.buckets, e - s, *head, (is_over[s:e], bool))
                upsert_globals(self.store, *self._cols_to_device(cols))

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

    def _cols_to_device(self, cols):
        kh, *rest = cols
        return [key_hash_tensor(kh, self.device)] + [
            torch.from_numpy(np.ascontiguousarray(c)).to(self.device) for c in rest
        ]

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
        idx = torch.from_numpy(sketch_indices_np(kh, wid, self.sketch_config))
        est = sketch_min(self.sketch.data, idx.to(self.device))
        return est.cpu().numpy().astype(np.int64)[:n]

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
        for B in (64, 128, 256, 512, 1024):
            kh = np.arange(1, B + 1, dtype=np.uint64) << np.uint64(32)
            self.sketch_estimates(kh, np.full(B, 1000, np.int64), now)
            self.live_mask(kh, now)

    def warmup(self, now: Optional[int] = None) -> None:
        """Run one decide (two-tier when the sketch is on) and one window
        install per ladder rung, plus the sketch reads (first launches,
        allocator pools, the kernel's build and load) so none of it lands
        inside a serving deadline; then wipe the state and counters the
        warmup traffic dirtied."""
        if now is None:
            now = api_types.millisecond_now()
        for b in self.buckets:
            k = np.arange(1, b + 1, dtype=np.uint64) << np.uint64(32)
            ones = np.ones(b, np.int64)
            self.decide_arrays(
                k, ones, ones * 10, ones * 1000,
                np.zeros(b, np.int32), np.zeros(b, bool), now,
            )
            self.install_windows(k, ones, ones, ones * now, np.zeros(b, bool), now)
        self._warmup_sketch_reads(now)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()
        self.stats = EngineStats()
        self.install_chunks = self.gossip_chunks = 0
