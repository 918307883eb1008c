"""Decision backends behind the serving tier (the port of
gubernator_tpu/serve/backends.py, with `make_backend` from
gubernator_tpu/serve/server.py:38-158).

The serving layer (serve/instance.py) speaks one small interface. The
port has four backends:

- `ExactBackend`, the reference's host LRU + exact oracle algorithms
  (core/cache.py, core/oracle.py), copied: no device state at all, chosen
  only by GUBER_BACKEND=exact. Its decide runs inline on the event loop.
- `TorchBackend`, the single-device slot store (+ count-min cold tier) of
  `TorchEngine`, in place of the reference's TpuBackend.
- `MeshBackend`, the same store sharded by key over a list of devices
  (`MeshEngine`, GUBER_BACKEND=mesh with GUBER_SHARDS).
- `MultiHostBackend`, the leader's backend over a mesh that spans
  processes (`MultiHostMeshEngine`, GUBER_BACKEND=multihost with the
  GUBER_DIST_* knobs; cli/daemon.py runs the followers).

`_ArrayOps` is the reference's array-level surface shared by its device
backends, copied: the object<->array seam the batcher's arrival prep and
merged submit run through, the GLOBAL hit apply, the replication
snapshot read, the promoter's engine surfaces, and the quota-chain
expansion (`decide_chain`, with `chain_level_keys` and
`collapse_chain_responses`).

Concurrency contract (the reference's): decide_submit calls are strictly
serialized on the batcher's one submit thread, while up to fetch_depth
decide_wait calls run concurrently on fetch threads and may overlap later
submits, touching only their own handle and the engine's stats.

`make_backend` lives here, not in serve/server.py as in the reference,
so that the serving core loads without the doors' grpc and aiohttp
imports.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    RateLimitResp,
    Status,
    hash_key,
    resps_from_columns,
)
from gubernator_tpu_torch.core.cache import LRUCache
from gubernator_tpu_torch.core.hashing import slot_hash_batch
from gubernator_tpu_torch.core.oracle import get_rate_limit
from gubernator_tpu_torch.core.store import DeviceLike, StoreConfig
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.backends")

#: rough host footprint of one replication standby row (a small dataclass
#: + dict node, the reference's measure), for the boot-time tier split
STANDBY_ENTRY_BYTES = 160


def chain_level_keys(r: RateLimitReq):
    """(cache_key, limit, duration) per level of a chained request,
    shallow -> deep, the request's own key last. A level duration of 0
    inherits the request's."""
    rows = [
        (hash_key(r.name, lv.unique_key), lv.limit, lv.duration or r.duration)
        for lv in r.chain
    ]
    rows.append((r.hash_key(), r.limit, r.duration))
    return rows


def collapse_chain_responses(resps):
    """Most restrictive wins: the FIRST (shallowest) OVER_LIMIT or
    erroring level's response answers the whole chained request, else
    the leaf's (every level admitted and was debited).
    `metadata["chain_level"]` names the refusing level's index when it
    is not the leaf."""
    pick = len(resps) - 1
    for j, resp in enumerate(resps):
        if resp.status == Status.OVER_LIMIT or resp.error:
            pick = j
            break
    out = resps[pick]
    if pick != len(resps) - 1:
        out.metadata["chain_level"] = str(pick)
    return out


class ExactBackend:
    """Host-memory exact semantics (reference algorithms over an LRU)."""

    # decide() is microseconds of pure-Python dict work: the batcher runs
    # it inline on the event loop (a thread hop per batch would cost more
    # than the decide), as the reference answers local cache hits
    # synchronously (gubernator.go:236-251). Device backends keep the
    # thread hop: they block on the device.
    inline_decide = True

    def __init__(self, cache_size: int = 50_000):
        self.cache = LRUCache(cache_size)

    def decide(
        self,
        reqs: Sequence[RateLimitReq],
        gnp: Sequence[bool],
        now: Optional[int] = None,
    ) -> List[RateLimitResp]:
        out = []
        for r, is_gnp in zip(reqs, gnp):
            if is_gnp:
                item, ok = self.cache.get(r.hash_key(), now)
                if ok and isinstance(item, RateLimitResp):
                    out.append(replace(item, metadata=dict(item.metadata)))
                    continue
                if ok:
                    # algorithm switched under a GLOBAL key: drop the stale
                    # entry and reprocess (gubernator.go:181-185)
                    self.cache.remove(r.hash_key())
                # miss: process locally as if owned (gubernator.go:189-194)
            out.append(get_rate_limit(self.cache, r, now))
        return out

    def update_globals(self, updates, now=None) -> None:
        # cache.Add(key, status, status.reset_time), gubernator.go:199-207;
        # `now` is unused (expiry comes from the status) but kept for
        # interface parity with the device backends
        for key, status in updates:
            self.cache.add(key, status, status.reset_time)

    def stats(self) -> dict:
        s = self.cache.stats()
        return dict(size=s.size, hit=s.hit, miss=s.miss)

    def snapshot_read(self, keys, now=None):
        """Bucket-replication snapshot surface (serve/replication.py): per
        key, (limit, duration, remaining, reset_time, over) for a live
        token window, else None. NON-MUTATING via LRUCache.peek (no
        recency move, no stats, no expiry deletion), so the flush loop is
        invisible to the decision stream. A cached token window has no
        duration: the manager backfills it from the dirtying request."""
        if now is None:
            now = api_types.millisecond_now()
        out = []
        for key in keys:
            v, ok = self.cache.peek(key, now)
            if not ok or not isinstance(v, RateLimitResp):
                out.append(None)
                continue
            out.append((
                v.limit,
                0,  # duration not persisted; the caller backfills
                v.remaining,
                v.reset_time,
                v.status == Status.OVER_LIMIT or v.remaining == 0,
            ))
        return out

    def shed_generation(self) -> int:
        """Store-wipe epoch for the over-limit shed cache: the host LRU
        never resets wholesale."""
        return 0

    def decide_chain(
        self, reqs: Sequence[RateLimitReq], now=None
    ) -> List[RateLimitResp]:
        """Hierarchical quota chains on the host backend: per request, peek
        every level, debit every level only if all admit, else answer from
        the first refusing level (most restrictive wins; nothing is
        consumed). Ancestors decide as TOKEN buckets, only the leaf with
        the request's algorithm, as on the device path. The peek pass is
        made non-mutating by snapshot/restore (a leaky peek persists its
        leak credit, the reference's quirk), and `planned` carries the
        charges earlier levels of the same chain would make per key, so a
        chain naming one key twice is judged against its post-charge
        budget (no partial debit)."""
        out = []
        for r in reqs:
            rows = chain_level_keys(r)
            levels = [
                replace(
                    r, unique_key="", name="", chain=[], hits=r.hits,
                    limit=lim, duration=dur,
                    algorithm=(
                        r.algorithm if j == len(rows) - 1
                        else Algorithm.TOKEN_BUCKET
                    ),
                )
                for j, (_k, lim, dur) in enumerate(rows)
            ]
            refuse = None
            planned: Dict[str, int] = {}
            saved = {key: self.cache.snapshot(key) for key, _l, _d in rows}
            for j, ((key, lim, _dur), lv) in enumerate(zip(rows, levels)):
                peek = self._decide_key(key, replace(lv, hits=0), now)
                already = planned.get(key, 0)
                if (
                    peek.status == Status.OVER_LIMIT
                    or r.hits + already > peek.remaining
                    or r.hits > lim
                ):
                    refuse = (j, peek, already)
                    break
                if r.hits > 0:
                    planned[key] = already + r.hits
            for key, snap in saved.items():
                if snap is None:
                    self.cache.remove(key)
                else:
                    self.cache.add(key, snap[0], snap[1])
            if refuse is not None:
                j, peek, already = refuse
                resp = RateLimitResp(
                    status=Status.OVER_LIMIT,
                    limit=peek.limit,
                    remaining=max(peek.remaining - already, 0),
                    reset_time=peek.reset_time,
                )
                if j != len(rows) - 1:
                    resp.metadata["chain_level"] = str(j)
                out.append(resp)
                continue
            out.append(collapse_chain_responses([
                self._decide_key(key, lv, now)
                for (key, _lim, _dur), lv in zip(rows, levels)
            ]))
        return out

    def _decide_key(self, key: str, r: RateLimitReq, now=None):
        """get_rate_limit against an explicit cache key: the oracle keys on
        name + "_" + unique_key, so split the key back into the two."""
        name, _, uk = key.partition("_")
        return get_rate_limit(self.cache, replace(r, name=name, unique_key=uk), now)


class _ArrayOps:
    """Array-level decide surface over `self.engine` (a TorchEngine):
    the seam the batcher flattens mixed batches through (array groups
    and request-object groups in ONE device submit)."""

    #: field order used everywhere a fields-dict is flattened
    ARRAY_FIELDS = ("key_hash", "hits", "limit", "duration", "algo", "gnp")

    def arrays_from_reqs(self, reqs, gnp) -> dict:
        n = len(reqs)
        return dict(
            key_hash=slot_hash_batch([r.hash_key() for r in reqs]),
            hits=np.fromiter((r.hits for r in reqs), np.int64, n),
            limit=np.fromiter((r.limit for r in reqs), np.int64, n),
            duration=np.fromiter((r.duration for r in reqs), np.int64, n),
            algo=np.fromiter((int(r.algorithm) for r in reqs), np.int32, n),
            gnp=np.asarray(list(gnp), bool),
        )

    def prep_group(self, fields: dict) -> dict:
        """Arrival-time per-group prep (serve/batcher.py): presort + clip
        one caller group on a prep-pool thread into a sorted run. `gnp`
        defaults to all-False like decide_submit_arrays' flush path."""
        if "gnp" not in fields:
            fields = dict(fields)
            fields["gnp"] = np.zeros(fields["key_hash"].shape[0], bool)
        return self.engine.prep_run(fields)

    def prep_reqs(self, reqs, gnp) -> dict:
        """prep_group for a request-object group: batch hashing + array
        conversion first."""
        return self.prep_group(self.arrays_from_reqs(reqs, gnp))

    def merge_prepped(self, runs):
        """Merge the groups' pre-sorted runs into one dispatch-ready
        batch (the submit thread's `merge` stage)."""
        return self.engine.merge_prepped(runs)

    def decide_submit_merged(self, merged, now: Optional[int] = None):
        """Dispatch one merge_prepped batch; fetch with decide_wait_arrays."""
        if now is None:
            now = api_types.millisecond_now()
        return self.engine.decide_submit_merged(merged, now)

    def decide_submit_arrays(self, fields: dict, now: Optional[int] = None):
        if fields["key_hash"].shape[0] == 0:
            return None
        if now is None:
            now = api_types.millisecond_now()
        return self.engine.decide_submit(now=now, **fields)

    def decide_wait_arrays(self, handle):
        """(status, limit, remaining, reset_time) int arrays."""
        if handle is None:
            z = np.empty(0, np.int64)
            return z, z, z, z
        return self.engine.decide_wait(handle)

    def counters(self) -> dict:
        """The engine's counters, with the distinct keys of the batches
        it dispatched (`groups`): host numbers, what the batcher meters
        after every batch."""
        return self.engine.stats.snapshot(groups=True)

    def stats(self) -> dict:
        """`counters()` and the store's occupied entries (`size`, the
        `cache_size` gauge, as upstream's LRU reports its own size),
        counted on the device when asked: a pass over the whole store in
        the serving stream's order, for a scrape, never a batch."""
        return dict(self.counters(), size=self.engine.occupied_entries())

    def attach_stages(self) -> None:
        """Point the engine's submit and fetch spans at the stage clock
        (serve/stages.py), as set_hot_observer points its observer; a
        replaced engine (repartition) is attached again."""
        self.engine.stages = STAGES

    @staticmethod
    def resps_from_arrays(status, limit, remaining, reset):
        return resps_from_columns(status, limit, remaining, reset)

    def snapshot_read(self, keys, now=None):
        """Bucket-replication snapshot surface over the device store: hash
        the keys once and gather their rows non-mutatingly
        (TorchEngine.snapshot_read). Runs on the batcher's submit thread
        (DeviceBatcher.run_serialized), never beside a dispatch."""
        return self.engine.snapshot_read(slot_hash_batch(list(keys)), now)

    def shed_generation(self) -> int:
        """Engine store-wipe epoch: the shed cache clears itself whenever
        this moves."""
        return self.engine.reset_generation

    def apply_global_hits_reqs(self, reqs, now=None):
        """Aggregated GLOBAL hits for keys this node owns, charged in one
        engine call (TorchEngine.apply_global_hits). Runs on the batcher's
        submit thread (DeviceBatcher.run_serialized). Returns the
        post-charge RateLimitResp per request, in caller order."""
        if not reqs:
            return []
        if now is None:
            now = api_types.millisecond_now()
        n = len(reqs)
        status, limit, remaining, reset = self.engine.apply_global_hits(
            slot_hash_batch([r.hash_key() for r in reqs]),
            np.fromiter((r.hits for r in reqs), np.int64, n),
            np.fromiter((r.limit for r in reqs), np.int64, n),
            np.fromiter((r.duration for r in reqs), np.int64, n),
            now,
            algo=np.fromiter((int(r.algorithm) for r in reqs), np.int32, n),
        )
        return self.resps_from_arrays(status, limit, remaining, reset)

    # -- sketch cold tier ----------------------------------------------------

    @property
    def sketch_enabled(self) -> bool:
        """True when the engine carries the count-min cold tier: the gate
        for the promoter (serve/promoter.py)."""
        return getattr(self.engine, "sketch", None) is not None

    def set_hot_observer(self, fn) -> None:
        """Attach the promoter's per-dispatch hot-key observer (called
        with every numpy BatchRequest the engine dispatches; None
        detaches)."""
        self.engine.observe_hook = fn

    def promote_hashes(self, key_hash, limits, durations, now=None):
        """Migrate hot sketch-tier keys into exact buckets
        (TorchEngine.promote_from_sketch). Runs on the batcher's submit
        thread (DeviceBatcher.run_serialized)."""
        return self.engine.promote_from_sketch(key_hash, limits, durations, now)

    # -- hierarchical quota chains --------------------------------------------

    def decide_chain(
        self, reqs: Sequence[RateLimitReq], now=None
    ) -> List[RateLimitResp]:
        """Chained decide on the device engine: expand every request into
        one row per level (shallow -> deep, leaf last; the request's hits
        charge EVERY level), run ONE chain-coupled decide over all of them
        (engine.decide_chain_arrays: no partial debit), and collapse each
        request's level responses, most restrictive wins. Ancestors are
        TOKEN counters; only the leaf carries the request's algorithm, so
        a shared ancestor never flips algorithm between callers. Runs on
        the batcher's submit thread: it submits AND waits."""
        if not reqs:
            return []
        if now is None:
            now = api_types.millisecond_now()
        keys, lims, durs, routes = [], [], [], []
        hits_l, algo_l, cids, spans = [], [], [], []
        for i, r in enumerate(reqs):
            rows = chain_level_keys(r)
            route = r.routing_key()
            for j, (key, lim, dur) in enumerate(rows):
                keys.append(key)
                lims.append(lim)
                durs.append(dur)
                routes.append(route)
                hits_l.append(r.hits)
                algo_l.append(int(r.algorithm) if j == len(rows) - 1 else 0)
                cids.append(i)
            spans.append(len(rows))
        status, limit, remaining, reset = self.engine.decide_chain_arrays(
            slot_hash_batch(keys),
            np.asarray(hits_l, np.int64),
            np.asarray(lims, np.int64),
            np.asarray(durs, np.int64),
            np.asarray(algo_l, np.int32),
            np.asarray(cids, np.int64),
            slot_hash_batch(routes),
            now,
        )
        out = []
        k = 0
        for span in spans:
            out.append(collapse_chain_responses(resps_from_columns(
                status[k : k + span], limit[k : k + span],
                remaining[k : k + span], reset[k : k + span],
            )))
            k += span
        return out


class TorchBackend(_ArrayOps):
    """Single-device slot-store backend (the reference's TpuBackend) on
    `device`: cuda unless the caller passes another (core.store.
    resolve_device)."""

    def __init__(
        self,
        store: StoreConfig = StoreConfig(),
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        sketch=None,
        device: DeviceLike = None,
    ):
        from gubernator_tpu_torch.parallel.sharded import TorchEngine

        self.engine = TorchEngine(store, buckets=buckets, device=device, sketch=sketch)
        self.attach_stages()

    @property
    def device(self):
        return self.engine.device

    def decide_submit(self, reqs, gnp, now=None):
        """Presort + dispatch without waiting; the batcher pipelines the
        next batch's host work against this batch's device time."""
        return self.engine.get_rate_limits_submit(reqs, now=now, gnp=list(gnp))

    def decide_wait(self, handle):
        return self.engine.get_rate_limits_wait(handle)

    def update_globals(self, updates, now=None):
        self.engine.update_globals(list(updates), now=now)

    def warmup(self) -> None:
        """Run every ladder rung once at boot (first launches, the kernel's
        build and load) so no request pays for it."""
        self.engine.warmup()

    def load_state(self, store_np, epoch, sketch_np=None) -> None:
        """Carry another engine's store, clock epoch and sketch across
        (TorchEngine.load_state)."""
        self.engine.load_state(store_np, epoch, sketch_np)


class MeshBackend(_ArrayOps):
    """Key-space sharded slot-store backend (the reference's MeshBackend):
    `MeshEngine` over a list of shard devices (every CUDA device unless
    the caller passes a list; a list may name one device more than once,
    so one GPU, or the CPU, holds several shards). The same surface as
    TorchBackend: the sketch cold tier (a sub-sketch a shard), the
    replication snapshot reads, the arrival-prep pipeline, quota chains
    and the one-step GLOBAL hit apply."""

    def __init__(
        self,
        store: StoreConfig = StoreConfig(),
        devices: Optional[Sequence[DeviceLike]] = None,
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        sketch=None,
        mesh_shape: Optional[Tuple[int, int]] = None,
    ):
        from gubernator_tpu_torch.parallel.sharded import MeshEngine

        self.engine = MeshEngine(
            store, devices=devices, buckets=buckets, mesh_shape=mesh_shape,
            sketch=sketch,
        )
        self.attach_stages()

    @property
    def device(self):
        """The leader shard's device (where the host reads combine)."""
        return self.engine.device

    def decide(self, reqs, gnp, now=None):
        if len(reqs) == 0:
            return []
        if now is None:
            now = api_types.millisecond_now()
        return self.resps_from_arrays(
            *self.engine.decide_arrays(now=now, **self.arrays_from_reqs(reqs, gnp))
        )

    def decide_submit(self, reqs, gnp, now=None):
        """Shard + dispatch without waiting: the batcher preps batch N+1
        while the shards decide batch N."""
        if len(reqs) == 0:
            return None
        if now is None:
            now = api_types.millisecond_now()
        return self.engine.decide_submit(now=now, **self.arrays_from_reqs(reqs, gnp))

    def decide_wait(self, handle):
        if handle is None:
            return []
        return self.resps_from_arrays(*self.engine.decide_wait(handle))

    def update_globals(self, updates, now=None):
        n = len(updates)
        if n == 0:
            return
        self.engine.update_globals(
            key_hash=slot_hash_batch([k for k, _ in updates]),
            limit=np.fromiter((s.limit for _, s in updates), np.int64, n),
            remaining=np.fromiter((s.remaining for _, s in updates), np.int64, n),
            reset_time=np.fromiter((s.reset_time for _, s in updates), np.int64, n),
            is_over=np.fromiter(
                (s.status == Status.OVER_LIMIT for _, s in updates), bool, n
            ),
            now=now,
        )

    def repartition(self, devices: Optional[Sequence[DeviceLike]] = None, now=None) -> None:
        """Re-shard the live store over another device list (every local
        device of the leader's kind by default; the GUBER_SHARDS-change
        path): every live window exports and
        reinstalls under the new ShardingPolicy, then the new engine
        replaces the old. One device degenerates to the flat TorchEngine.
        Run with the batcher idle or on its submit thread
        (DeviceBatcher.run_serialized), and warm up before serving."""
        from gubernator_tpu_torch.parallel.policy import ShardingPolicy, local_devices

        if devices is None:
            devices = local_devices(self.engine.device)
        devices = list(devices)
        policy = (
            ShardingPolicy.single(devices[0])
            if len(devices) == 1
            else ShardingPolicy.over_mesh(devices)
        )
        old = self.engine
        self.engine = old.repartition(policy, now=now)
        self.attach_stages()
        old.close()  # the old engine's graphs and their pools

    def warmup(self) -> None:
        """Every (sub-batch rung, group rung) pair once a program (each
        captured on a GPU), and the install and sync at each host rung
        (MeshEngine.warmup), so no request pays for them."""
        self.engine.warmup()

    def load_state(self, store_np, epoch, sketch_np=None) -> None:
        """Carry another mesh's [n_shards, ...] store, clock epoch and
        sketch across (MeshEngine.load_state)."""
        self.engine.load_state(store_np, epoch, sketch_np)


class MultiHostBackend(MeshBackend):
    """The leader's backend over a mesh that spans processes: construct
    it only on process 0, after initialize_distributed; every other
    process runs MultiHostMeshEngine.follower_loop instead of serving
    (cli/daemon.py wires both roles from the GUBER_DIST_* knobs). The
    lockstep wrapper keeps the submit/wait split (followers dispatch and
    move on; the gather of their rows is waited on at fetch), so the
    fetch-depth pipeline and the arrival-prep merge work across
    processes too. Without a process group the engine is a one-process
    mesh over `devices` (every local device of the default kind when
    None) with no step pipe."""

    def __init__(
        self,
        store: StoreConfig = StoreConfig(),
        followers: Sequence[str] = (),
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        sketch=None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        from gubernator_tpu_torch.parallel.multihost import MultiHostMeshEngine

        self.engine = MultiHostMeshEngine(
            store, followers=list(followers), buckets=buckets, sketch=sketch,
            devices=devices,
        )
        self.attach_stages()

    def close(self) -> None:
        """Shut the step pipe (each follower's loop ends) and release
        this process's captured decides."""
        self.engine.close()

    def stats(self) -> dict:
        """`counters()` without `size`: the leader holds only its own
        shards of the store."""
        return self.counters()


def mesh_devices(shards: int, device: DeviceLike = None) -> list:
    """The shard list GUBER_BACKEND=mesh serves on: the first
    GUBER_SHARDS CUDA devices (all of them at 0; more than there are is
    refused), or on the CPU GUBER_SHARDS shards of the one CPU (1 at 0),
    the port's counterpart of the reference's simulated host devices."""
    from gubernator_tpu_torch.parallel.policy import local_devices

    avail = local_devices(device)
    if avail[0].type == "cpu":
        return [avail[0]] * max(shards, 1)
    if shards > len(avail):
        raise ValueError(
            f"GUBER_SHARDS={shards} exceeds the {len(avail)} visible CUDA "
            "devices; pass make_backend an explicit devices= list to hold "
            "several shards on one device"
        )
    return list(avail[:shards] if shards else avail)


def make_backend(conf, device: DeviceLike = None, devices: Optional[Sequence] = None):
    """The backend a ServerConfig asks for, on `device` (cuda unless the
    caller passes another). GUBER_BACKEND=mesh shards over `devices` when
    the caller passes a list, else over mesh_devices(GUBER_SHARDS,
    device); GUBER_BACKEND=multihost holds `devices`, else every local
    device of `device`'s kind, and follows GUBER_DIST_FOLLOWERS. Resolves
    the store sizing knobs, logs the per-tier footprint and runs the
    whole-host budget lint, as the reference's make_backend does."""
    if conf.backend == "exact":
        return ExactBackend(conf.cache_size)
    if conf.backend not in ("tpu", "mesh", "multihost"):
        raise ValueError(f"unknown backend '{conf.backend}'")
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.core.sketches import sketch_footprint_bytes
    from gubernator_tpu_torch.core.store import (
        check_host_budget,
        store_capacity,
        store_footprint_bytes,
    )
    from gubernator_tpu_torch.serve.shedcache import ENTRY_BYTES as SHED_BYTES

    store = conf.store_config(logger=log)
    sketch = conf.sketch_config()
    sketch_bytes = sketch_footprint_bytes(sketch) if sketch is not None else 0
    shed_bytes = conf.shed_cache_keys * SHED_BYTES if conf.shed_cache else 0
    standby_bytes = (
        conf.replication_standby_keys * STANDBY_ENTRY_BYTES
        if conf.replication else 0
    )
    log.info(
        "store tiers: exact %d slots x %d ways = %d entries (%.0f MiB)"
        "%s + shed %.1f MiB + standby %.1f MiB",
        store.slots, store.rows, store_capacity(store),
        store_footprint_bytes(store) / (1 << 20),
        (
            f" + sketch {sketch.rows}x{sketch.width} "
            f"int{sketch.counter_bytes * 8} "
            f"({sketch_bytes / (1 << 20):.0f} MiB)"
            if sketch is not None
            else " (sketch tier off)"
        ),
        shed_bytes / (1 << 20),
        standby_bytes / (1 << 20),
    )
    host_lint = check_host_budget(
        conf.store_mib,
        {
            "exact store": store_footprint_bytes(store),
            "sketch": sketch_bytes,
            "shed cache": shed_bytes,
            "replication standby": standby_bytes,
        },
    )
    if host_lint:
        # STRICT hard-fails only when a host-side part was sized
        # explicitly; the default shed cache overflows any tiny budget on
        # its own, and those boots warn instead (the reference's rule)
        fields = type(conf).__dataclass_fields__
        host_explicit = (
            conf.shed_cache_keys != fields["shed_cache_keys"].default
        ) or (
            conf.replication
            and conf.replication_standby_keys
            != fields["replication_standby_keys"].default
        )
        if conf.store_size_strict and host_explicit:
            raise ValueError(f"GUBER_STORE_SIZE_STRICT: {host_lint}")
        log.warning("%s", host_lint)
    buckets = buckets_for_limit(conf.device_batch_limit)
    if conf.device_deep_batch:
        log.info(
            "throughput mode: deep-batch accumulation toward %d (ladder %s)",
            conf.device_batch_limit, buckets,
        )
    if conf.backend == "tpu":
        return TorchBackend(store, buckets=buckets, sketch=sketch, device=device)
    if conf.backend == "multihost":
        from gubernator_tpu_torch.parallel.policy import local_devices

        backend = MultiHostBackend(
            store, followers=conf.dist_followers, buckets=buckets, sketch=sketch,
            devices=devices if devices is not None else local_devices(device),
        )
        log.info("partitioned engine: %s", backend.engine.policy.describe())
        return backend
    if devices is None:
        devices = mesh_devices(conf.shards, device)
    backend = MeshBackend(store, devices=devices, buckets=buckets, sketch=sketch)
    # the operator's confirmation that GUBER_SHARDS took effect
    log.info("partitioned engine: %s", backend.engine.policy.describe())
    return backend
