"""Decision backends behind the serving tier (the port of
gubernator_tpu/serve/backends.py, with `make_backend` from
gubernator_tpu/serve/server.py:38-158).

The serving layer (serve/instance.py) speaks one small interface. The
port has one backend so far: `TorchBackend`, the single-device slot store
(+ count-min cold tier) of `TorchEngine`, in place of the reference's
TpuBackend. `_ArrayOps` is the reference's array-level surface shared by
its device backends, copied: the object<->array seam the batcher's
arrival prep and merged submit run through, the GLOBAL hit apply, and
the promoter's engine surfaces. Not ported yet: ExactBackend (it sits on
the reference's host LRU and oracle), the mesh and multi-host backends,
and quota chains (`decide_chain` raises NotImplementedError, as the
engine does).

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
from typing import List, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.api.types import RateLimitReq, RateLimitResp, resps_from_columns
from gubernator_tpu_torch.core.hashing import slot_hash_batch
from gubernator_tpu_torch.core.store import DeviceLike, StoreConfig

log = logging.getLogger("gubernator_tpu_torch.backends")

#: the reference's backends that the port does not carry yet
NOT_PORTED_BACKENDS = ("exact", "mesh", "multihost")


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

    @staticmethod
    def resps_from_arrays(status, limit, remaining, reset):
        return resps_from_columns(status, limit, remaining, reset)

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

    def decide_chain(
        self, reqs: Sequence[RateLimitReq], now=None
    ) -> List[RateLimitResp]:
        raise NotImplementedError(
            "quota chains are not ported to gubernator_tpu_torch yet"
        )


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

    def stats(self) -> dict:
        return self.engine.stats.snapshot()


def make_backend(conf, device: DeviceLike = None):
    """The backend a ServerConfig asks for, on `device` (cuda unless the
    caller passes another). Resolves the store sizing knobs, logs the
    per-tier footprint and runs the whole-host budget lint, as the
    reference's make_backend does."""
    if conf.backend in NOT_PORTED_BACKENDS:
        raise ValueError(
            f"GUBER_BACKEND={conf.backend} is not ported to "
            f"gubernator_tpu_torch yet (only 'tpu', the single-device "
            f"backend, is); not ported: {', '.join(NOT_PORTED_BACKENDS)}"
        )
    if conf.backend != "tpu":
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
        0.0,  # replication standby: replication is not ported yet
    )
    host_lint = check_host_budget(
        conf.store_mib,
        {
            "exact store": store_footprint_bytes(store),
            "sketch": sketch_bytes,
            "shed cache": shed_bytes,
        },
    )
    if host_lint:
        # STRICT hard-fails only when the host-side part was sized
        # explicitly; the default shed cache overflows any tiny budget on
        # its own, and those boots warn instead (the reference's rule)
        default_keys = type(conf).__dataclass_fields__["shed_cache_keys"].default
        if conf.store_size_strict and conf.shed_cache_keys != default_keys:
            raise ValueError(f"GUBER_STORE_SIZE_STRICT: {host_lint}")
        log.warning("%s", host_lint)
    buckets = buckets_for_limit(conf.device_batch_limit)
    if conf.device_deep_batch:
        log.info(
            "throughput mode: deep-batch accumulation toward %d (ladder %s)",
            conf.device_batch_limit, buckets,
        )
    return TorchBackend(store, buckets=buckets, sketch=sketch, device=device)
