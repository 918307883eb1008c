"""TorchEngine: the single-device engine (PyTorch port of the flat half
of gubernator_tpu.parallel.sharded.PartitionedEngine).

Host glue + the exact-tier decide for a slot store resident on one
device: presort and pad each batch on the host (core.engine), copy the
padded arrays to the device, run the decide (which updates the store
tensor in place; JAX donates it instead), and fetch ONE packed int32
array of responses + stats per batch.

Ported surfaces: construction, reset and the epoch clock with its store
rebase, the request-object API (get_rate_limits[_submit/_wait]), the
array API (decide_submit / decide_wait / decide_arrays), warmup, and
load_state, which carries a JAX engine's store and clock across. Not
ported in this slice: the mesh policy, the sketch cold tier, quota
chains, GLOBAL replica install/sync, the promoter's host reads and the
arrival-prep merge path.

Thread model: not thread-safe, like the reference engine; one serving
thread owns it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.core.engine import (
    EngineStats,
    EpochClock,
    pad_request_sorted,
    to_device,
    unpermute_responses,
)
from gubernator_tpu_torch.core.kernels import (
    decide_presorted,
    pack_outputs,
    unpack_outputs,
)
from gubernator_tpu_torch.core.store import (
    DeviceLike,
    StoreConfig,
    new_store,
    rebase,
    resolve_device,
)


class TorchEngine:
    """Single-device engine over a slot store on `device` (cuda unless
    the caller passes another; see core.store.resolve_device)."""

    def __init__(
        self,
        config: StoreConfig = StoreConfig(),
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        device: DeviceLike = None,
    ):
        self.config = config
        self.buckets = sorted(buckets)
        self.device = resolve_device(device)
        self.clock = EpochClock()
        self.stats = EngineStats()
        self.store = new_store(config, self.device)

    def reset(self) -> None:
        """Wipe the store in place (the clock keeps its epoch)."""
        self.store.data.zero_()

    def _engine_now(self, now: int) -> np.int32:
        e, delta, reset_required = self.clock.advance(now)
        if reset_required:
            self.reset()
        elif delta is not None:
            rebase(self.store, delta)
        return e

    def load_state(self, store_np: np.ndarray, epoch: Optional[int]) -> None:
        """Carry another engine's state across: the int32[buckets, W]
        store bytes (e.g. a JAX TpuEngine's `np.asarray(store.data)`)
        and its clock epoch (`clock.epoch`)."""
        want = tuple(self.store.data.shape)
        if store_np.dtype != np.int32 or tuple(store_np.shape) != want:
            raise ValueError(
                f"store {store_np.dtype}{list(store_np.shape)} does not "
                f"match this engine's int32{list(want)}"
            )
        arr = np.require(store_np, requirements=["C", "W"])
        self.store.data.copy_(torch.from_numpy(arr))
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

    def decide_submit(
        self,
        key_hash: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        algo: np.ndarray,
        gnp: np.ndarray,
        now: int,
    ):
        """Presort + dispatch one batch WITHOUT waiting for the device.
        The store update is queued on the device stream at once, so the
        next submit may follow immediately. Returns a handle for
        decide_wait that captures the submit-time epoch."""
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
        req_t = to_device(req, self.device)
        groups_t = to_device(groups, self.device)
        _store, resp, stats = decide_presorted(self.store, req_t, e_now, groups_t)
        packed = pack_outputs(resp, stats)
        return packed, order, n, req.key_hash.shape[0], self.clock.epoch

    def decide_wait(
        self, handle
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fetch + unpermute the responses for a decide_submit handle:
        (status, limit, remaining, reset_time int64 unix-ms)."""
        packed, order, n, B, epoch = handle
        packed = packed.cpu().numpy()
        self.stats.add_batch(
            int(packed[4 * B]),
            int(packed[4 * B + 1]),
            int(packed[4 * B + 2]),
            int(packed[4 * B + 3]),
        )
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

    def warmup(self, now: Optional[int] = None) -> None:
        """Run one decide per ladder rung (first launches, allocator
        pools, the kernel's build and load) so none of it lands inside a
        serving deadline, then wipe the state and counters the warmup
        traffic dirtied."""
        if now is None:
            now = api_types.millisecond_now()
        for b in self.buckets:
            k = np.arange(1, b + 1, dtype=np.uint64) << np.uint64(32)
            ones = np.ones(b, np.int64)
            self.decide_arrays(
                k, ones, ones * 10, ones * 1000,
                np.zeros(b, np.int32), np.zeros(b, bool), now,
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()
        self.stats = EngineStats()
