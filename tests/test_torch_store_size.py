"""The device backends' `stats()["size"]`: the store's occupied entries,
counted on the device a block of rows at a time, as upstream's LRU
reports its size. After seeded batches on the exact, two-tier and mesh
engines it equals a plain NumPy count of the entries whose tag lane is
set in the store's bytes; a scrape sets `cache_size` from it, and each
count is one `store_size` span of the stage clock."""

from __future__ import annotations

import numpy as np
import pytest

from gubernator_tpu_torch.core.sketches import SketchConfig
from gubernator_tpu_torch.core.store import L_TAG, LANES, StoreConfig
from gubernator_tpu_torch.parallel import sharded
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.backends import MeshBackend, MultiHostBackend, TorchBackend
from gubernator_tpu_torch.serve.config import ServerConfig
from gubernator_tpu_torch.serve.server import Server
from gubernator_tpu_torch.serve.stages import STAGES

T0 = 1_700_000_000_000
GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _backend(kind: str):
    store = StoreConfig(rows=16, slots=64)
    if kind == "mesh":
        return MeshBackend(store, devices=["cpu", "cpu"], buckets=(64, 256, 1024))
    sketch = SketchConfig(rows=2, width=1 << 10) if kind == "two_tier" else None
    return TorchBackend(store, buckets=(64, 256, 1024), sketch=sketch, device="cpu")


def _occupied_np(backend) -> int:
    """Entries with a tag, from the store's bytes on the host."""
    return int(np.count_nonzero(backend.engine.store_numpy().reshape(-1, LANES)[:, L_TAG]))


@pytest.mark.parametrize("kind", ["exact", "two_tier", "mesh"])
def test_size_is_the_occupied_entries_and_sets_cache_size(kind, monkeypatch):
    # blocks of 16 rows: the 64-row store is counted in several blocks
    monkeypatch.setattr(sharded, "OCCUPIED_BLOCK_ROWS", 16)
    backend = _backend(kind)
    assert backend.stats()["size"] == 0
    rng = np.random.default_rng(11)
    now = T0
    for n, keys in ((600, 300), (900, 2000), (1024, 5000)):
        now += int(rng.integers(0, 5000))
        f = dict(key_hash=rng.integers(1, keys + 1, n).astype(np.uint64) * GOLDEN,
                 hits=np.ones(n, np.int64), limit=np.full(n, 5, np.int64),
                 duration=rng.choice([1000, 60_000], n).astype(np.int64),
                 algo=np.zeros(n, np.int32), gnp=np.zeros(n, bool))
        backend.decide_wait_arrays(backend.decide_submit_arrays(f, now))
        want = _occupied_np(backend)
        assert 0 < want <= 16 * 64 * backend.engine.n
        assert backend.stats()["size"] == want
    if kind == "two_tier":
        assert backend.stats()["dropped"] > 0  # the store overflowed into the sketch

    srv = Server(ServerConfig(backend="tpu"), backend=backend)
    STAGES.reset()
    srv._refresh_store_metrics()
    assert metrics.CACHE_SIZE._value.get() == _occupied_np(backend)
    assert STAGES.snapshot()["stages"]["store_size"]["count"] == 1


def test_multihost_leader_reports_no_size():
    """A multi-host leader holds only its own shards: no `size`, and so
    no `cache_size` from a partial count."""
    backend = MultiHostBackend(StoreConfig(rows=16, slots=16), buckets=(64, 256),
                               devices=["cpu", "cpu"])
    assert "size" not in backend.stats() and "groups" in backend.stats()


def test_the_batcher_meters_counters_without_counting_the_store():
    """The batcher meters the cache counters after every batch through
    `counters()`: no batch pays for a pass over the store (a 64 GiB store
    takes tens of ms a pass on an H100)."""
    import asyncio

    from gubernator_tpu_torch.api.types import PeerInfo
    from gubernator_tpu_torch.serve.instance import Instance

    backend = _backend("exact")
    counted = []
    occupied = backend.engine.occupied_entries
    backend.engine.occupied_entries = lambda: counted.append(1) or occupied()
    misses0 = metrics.CACHE_ACCESS_COUNT.labels(type="miss")._value.get()

    async def run():
        conf = ServerConfig(backend="tpu", grpc_address="127.0.0.1:9990")
        inst = Instance(conf, backend)
        inst.start()
        await inst.set_peers([PeerInfo(address=conf.grpc_address, is_owner=True)])
        rng = np.random.default_rng(3)
        try:
            for _ in range(4):
                n = 300
                await inst.batcher.decide_arrays(dict(
                    key_hash=rng.integers(1, 500, n).astype(np.uint64) * GOLDEN,
                    hits=np.ones(n, np.int64), limit=np.full(n, 5, np.int64),
                    duration=np.full(n, 60_000, np.int64), algo=np.zeros(n, np.int32)))
        finally:
            await inst.stop()

    asyncio.run(run())
    assert backend.counters()["batches"] >= 1 and not counted
    assert metrics.CACHE_ACCESS_COUNT.labels(type="miss")._value.get() > misses0
    assert backend.stats()["size"] == _occupied_np(backend) and counted == [1]
