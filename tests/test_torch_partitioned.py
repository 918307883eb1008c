"""The port's one engine under two policies on the CPU: the cases of
tests/test_partitioned.py, each held against the JAX package's
PartitionedEngine on the 8 simulated devices of tests/conftest.py.

- a 1-shard mesh is the flat engine's twin even under eviction pressure
  (and the JAX 1-device mesh's);
- shard count 1 vs 8 through the real serving pipeline (Instance ->
  batcher -> arrival prep -> merged submit -> the per-shard decides)
  under a pinned clock, the sketch tier on: byte-identical answers, and
  the 8-shard port Instance answers as the JAX package's 8-device one;
- the sharded sketch tier: each key charges only its owner's sub-sketch,
  estimates never under-count and stay within the per-shard e*N_s/width
  bound, equal to the JAX mesh's; the window ring under pressure on the
  mesh stays fail-closed (and decides as the JAX mesh);
- the promoter on the mesh backend promotes hot sketch keys on their
  owners;
- apply_global_hits: owner charge + combine + replica install equals the
  flat engine's sequential decide, and the JAX mesh's; the replication
  snapshot surface; gossip above the ladder top (flat chunks, the mesh
  extends its ladder), flat == mesh.
"""

import asyncio
import math

import jax
import numpy as np
import pytest

from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.parallel.sharded import MeshEngine as JMeshEngine
from gubernator_tpu_torch.api.types import Algorithm, PeerInfo, RateLimitReq
from gubernator_tpu_torch.core.sketches import SketchConfig
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.parallel.sharded import MeshEngine, TorchEngine, owner_of_np
from gubernator_tpu_torch.serve.backends import MeshBackend, TorchBackend
from gubernator_tpu_torch.serve.config import ServerConfig
from gubernator_tpu_torch.serve.instance import Instance
from test_torch_hash import pin_hash
from test_torch_replication import FakeClock, _assert_same, _jax_req, _pin_clock

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7975"
CPU8 = ["cpu"] * 8


def same_out(a, b, ctx=""):
    for name, x, y in zip(("status", "limit", "remaining", "reset"), a, b):
        np.testing.assert_array_equal(
            np.asarray(x, np.int64), np.asarray(y, np.int64), err_msg=f"{ctx} {name}"
        )


def test_single_vs_one_shard_mesh_identical_under_pressure():
    """A 1-shard mesh IS the degenerate case: same table geometry, same
    kernel, byte-identical decisions under way-exhaustion pressure (and
    the JAX 1-device mesh's)."""
    flat = TorchEngine(StoreConfig(rows=1, slots=16), buckets=(64, 256), device="cpu")
    mesh1 = MeshEngine(StoreConfig(rows=1, slots=16), devices=["cpu"], buckets=(64, 256))
    jmesh1 = JMeshEngine(JStoreConfig(rows=1, slots=16), devices=jax.devices()[:1],
                         buckets=(64, 256))
    assert mesh1.n == 1 == jmesh1.n
    rng = np.random.default_rng(3)
    for step in range(12):
        n = int(rng.integers(1, 120))
        args = (
            rng.integers(1, 1 << 63, n).astype(np.uint64),
            rng.integers(0, 4, n).astype(np.int64), np.full(n, 5, np.int64),
            np.full(n, 60_000, np.int64), rng.integers(0, 2, n).astype(np.int32),
            np.zeros(n, bool), T0 + step,
        )
        a = flat.decide_arrays(*args)
        same_out(a, mesh1.decide_arrays(*args), f"step {step}")
        same_out(a, jmesh1.decide_arrays(*args), f"step {step} jax")
    st = flat.stats.snapshot()
    assert st["evictions"] + st["dropped"] > 0  # pressure happened
    assert st == mesh1.stats.snapshot() == jmesh1.stats.snapshot()
    np.testing.assert_array_equal(mesh1.store_numpy()[0], flat.store_numpy())
    np.testing.assert_array_equal(mesh1.store_numpy(), np.asarray(jmesh1.store.data))


def test_shard_count_identity_through_serving_pipeline(monkeypatch):
    """Shard count 1 vs 8, byte-identical through the real pipeline under
    a pinned clock with exact-tier keys and the sketch on; the 8-shard
    port Instance also answers as the JAX package's 8-device one."""
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.core.sketches import SketchConfig as JSK
    from gubernator_tpu.serve.backends import MeshBackend as JMeshBackend
    from gubernator_tpu.serve.config import ServerConfig as JServerConfig
    from gubernator_tpu.serve.instance import Instance as JInstance

    clock = FakeClock()
    _pin_clock(monkeypatch, clock)
    pin_hash(monkeypatch, "blake2b")

    def be(n_shards: int):
        store = StoreConfig(rows=16, slots=1 << 10)
        sketch = SketchConfig(rows=4, width=1 << 12)
        if n_shards == 1:
            return TorchBackend(store, buckets=(16, 64), sketch=sketch, device="cpu")
        return MeshBackend(store, devices=["cpu"] * n_shards, buckets=(16, 64), sketch=sketch)

    async def mk(n_shards: int):
        conf = ServerConfig(
            grpc_address=ADDR, advertise_address=ADDR,
            backend="tpu" if n_shards == 1 else "mesh", sketch_sync_wait=600.0,
        )
        inst = Instance(conf, be(n_shards))
        inst.start()
        await inst.set_peers([PeerInfo(address=ADDR, is_owner=True)])
        return inst

    async def run():
        one, eight = await mk(1), await mk(8)
        twin = JInstance(
            JServerConfig(grpc_address=ADDR, advertise_address=ADDR, backend="mesh",
                          sketch_sync_wait=600.0),
            JMeshBackend(JStoreConfig(rows=16, slots=1 << 10), devices=jax.devices(),
                         buckets=(16, 64), sketch=JSK(rows=4, width=1 << 12)),
        )
        twin.start()
        await twin.set_peers([jt.PeerInfo(address=ADDR, is_owner=True)])
        assert eight.backend.engine.n == 8 == twin.backend.engine.n
        for inst in (one, eight, twin):
            if inst.shed is not None:
                inst.shed.now_fn = clock
        try:
            rng = np.random.default_rng(17)
            keys = [f"p{i}" for i in range(40)]
            for step in range(80):
                clock.t += int(rng.choice([0, 1, 9, 200, 2500]))
                n = int(rng.integers(1, 9))
                batch = [
                    RateLimitReq(
                        name="shardfuzz", unique_key=keys[int(rng.integers(len(keys)))],
                        hits=int(rng.choice([0, 1, 1, 2, 7])),
                        limit=int(rng.choice([1, 2, 3, 50])),
                        duration=int(rng.choice([400, 2000, 60_000])),
                        algorithm=Algorithm(int(rng.integers(2))),
                    )
                    for _ in range(n)
                ]
                a = await one.get_rate_limits(batch)
                b = await eight.get_rate_limits(batch)
                c = await twin.get_rate_limits([_jax_req(r) for r in batch])
                for x, y, z, r in zip(a, b, c, batch):
                    _assert_same(x, y, (step, r))
                    _assert_same(y, z, (step, r, "jax"))
            assert one.backend.stats()["dropped"] == 0
            assert eight.backend.stats()["dropped"] == 0
            np.testing.assert_array_equal(
                eight.backend.engine.store_numpy(), np.asarray(twin.backend.engine.store.data)
            )
            np.testing.assert_array_equal(
                eight.backend.engine.sketch_numpy(),
                np.asarray(twin.backend.engine.sketch.data),
            )
        finally:
            await one.stop()
            await eight.stop()
            await twin.stop()

    asyncio.run(run())


# -- sharded sketch tier ----------------------------------------------------------


def _cover_all_buckets(n_shards: int, slots: int) -> np.ndarray:
    """One immortal filler key per (shard, bucket) pair: with every way
    pinned live, later creates are provably sketch-served."""
    from gubernator_tpu_torch.core.store import group_sort_key_np

    need = {(s, b) for s in range(n_shards) for b in range(slots)}
    out = []
    v = 1
    while need:
        arr = np.asarray([(v << 32) | 9], np.uint64)
        s = int(owner_of_np(arr, n_shards)[0])
        b = int(group_sort_key_np(arr, slots)[0] >> np.uint64(32))
        if (s, b) in need:
            need.remove((s, b))
            out.append(arr[0])
        v += 1
    return np.asarray(out, np.uint64)


def test_sharded_sketch_error_bound_zero_undercount():
    """Every bucket of every shard pinned live, measured keys all
    sketch-served: no under-count, the max overestimate within each
    shard's e*N_s/width bound; estimates and stats equal the JAX mesh's."""
    slots, width = 16, 1 << 12
    eng = MeshEngine(StoreConfig(rows=1, slots=slots), devices=CPU8,
                     buckets=(64, 256, 1024), sketch=SketchConfig(rows=4, width=width))
    jeng = JMeshEngine(JStoreConfig(rows=1, slots=slots), buckets=(64, 256, 1024),
                       sketch=JSketchConfig(rows=4, width=width))
    fillers = _cover_all_buckets(eng.n, slots)
    nf = fillers.shape[0]
    ones_f = np.ones(nf, np.int64)
    for e in (eng, jeng):
        e.decide_arrays(fillers, ones_f, ones_f * 1000, ones_f * 1_000_000_000,
                        np.zeros(nf, np.int32), np.zeros(nf, bool), T0)
    assert eng.stats.snapshot()["dropped"] == 0
    D, LIM, n_keys = 600_000, 1_000_000, 300
    meas = ((np.arange(1, n_keys + 1, dtype=np.uint64) + np.uint64(10_000_000))
            << np.uint64(32)) | np.uint64(3)
    true = np.zeros(n_keys, np.int64)
    rng = np.random.default_rng(23)
    for step in range(6):
        hits_m = rng.integers(1, 5, n_keys).astype(np.int64)
        true += hits_m
        kh = np.concatenate([fillers, meas])
        hits = np.concatenate([np.zeros(nf, np.int64), hits_m])
        n = kh.shape[0]
        args = (kh, hits, np.full(n, LIM, np.int64), np.full(n, D, np.int64),
                np.zeros(n, np.int32), np.zeros(n, bool), T0 + 1 + step)
        same_out(eng.decide_arrays(*args), jeng.decide_arrays(*args), f"step {step}")
    st = eng.stats.snapshot()
    assert st == jeng.stats.snapshot()
    assert st["dropped"] >= 6 * n_keys, st
    assert st["evictions"] == 0, st
    est = eng.sketch_estimates(meas, np.full(n_keys, D, np.int64), T0 + 50)
    np.testing.assert_array_equal(
        est, jeng.sketch_estimates(meas, np.full(n_keys, D, np.int64), T0 + 50)
    )
    np.testing.assert_array_equal(eng.sketch_numpy(), np.asarray(jeng.sketch.data))
    assert int((est < true).sum()) == 0
    owners = owner_of_np(meas, eng.n)
    over = (est - true).astype(np.int64)
    for s_i in range(eng.n):
        m = owners == s_i
        if m.any():
            bound = math.e * int(true[m].sum()) / width
            assert over[m].max() <= max(bound, 0), (s_i, int(over[m].max()), bound)
    assert over.max() <= math.e * int(true.sum()) / width


@pytest.mark.parametrize("algo", [2, 3], ids=["sliding", "gcra"])
def test_mesh_window_ring_pressure_is_fail_closed(algo):
    """The window ring on the 8-shard mesh: sliding/GCRA creates dropped to
    way exhaustion are served from the per-shard sub-rings, every served
    row at least as restrictive as the bypass (the engine without the
    tier), and the tier's decisions equal the JAX mesh's."""
    slots = 16

    def mk(sk):
        return MeshEngine(StoreConfig(rows=1, slots=slots), devices=CPU8,
                          buckets=(64, 256, 1024),
                          sketch=SketchConfig(rows=4, width=1 << 12) if sk else None)

    on, off = mk(True), mk(False)
    jon = JMeshEngine(JStoreConfig(rows=1, slots=slots), buckets=(64, 256, 1024),
                      sketch=JSketchConfig(rows=4, width=1 << 12))
    fillers = _cover_all_buckets(on.n, slots)
    nf = fillers.shape[0]
    ones_f = np.ones(nf, np.int64)
    for eng in (on, off, jon):
        eng.decide_arrays(fillers, ones_f, ones_f * 1000, ones_f * 1_000_000_000,
                          np.zeros(nf, np.int32), np.zeros(nf, bool), T0)
        assert eng.stats.snapshot()["dropped"] == 0
    rng = np.random.default_rng(31)
    keyspace = 48
    pool = ((np.arange(1, keyspace + 1, dtype=np.uint64) + np.uint64(5_000_000))
            << np.uint64(32)) | np.uint64(3)
    DUR, LIM = 10_000, 6
    t = T0
    diverged = 0
    for step in range(50):
        n = int(rng.integers(1, 24))
        kh_m = pool[rng.integers(0, keyspace, n)]
        hits_m = rng.choice((0, 1, 1, 1), n).astype(np.int64)
        t += int(rng.choice((0, 1, 7, 500, 2500, 12_000, 21_000)))
        kh = np.concatenate([fillers, kh_m])
        hits = np.concatenate([np.zeros(nf, np.int64), hits_m])
        lim = np.full(nf + n, LIM, np.int64)
        lim[:nf] = 1000
        dur = np.full(nf + n, DUR, np.int64)
        dur[:nf] = 1_000_000_000
        al = np.full(nf + n, algo, np.int32)
        al[:nf] = 0
        gnp = np.zeros(nf + n, bool)
        sa, _, ra, _ = got = on.decide_arrays(kh, hits, lim, dur, al, gnp, t)
        same_out(got, jon.decide_arrays(kh, hits, lim, dur, al, gnp, t), f"step {step}")
        sb, _, rb, _ = off.decide_arrays(kh, hits, lim, dur, al, gnp, t)
        diverged += int(((sa[nf:] != sb[nf:]) | (ra[nf:] != rb[nf:])).sum())
        assert (sa[nf:] >= sb[nf:]).all(), f"fail-open status @{step}"
        assert (ra[nf:] <= rb[nf:]).all(), f"fail-open remaining @{step}"
    assert diverged > 0, "mesh pressure fuzz never engaged the ring"
    st = on.stats.snapshot()
    assert st == jon.stats.snapshot()
    assert st["dropped"] > 0 and st["evictions"] == 0, st
    np.testing.assert_array_equal(on.sketch_numpy(), np.asarray(jon.sketch.data))
    assert not off.live_mask(pool, t).any()


def test_mesh_sketch_promoter_end_to_end():
    """The promoter runs on the mesh backend (fed by the owner-masked
    estimate reads), promotes hot sketch keys into exact buckets on their
    owner shards, and GUBER_SKETCH=1 boots on GUBER_BACKEND=mesh."""
    conf = ServerConfig(grpc_address=ADDR, advertise_address=ADDR, backend="mesh",
                        sketch_sync_wait=600.0, sketch_topk=64)
    assert conf.sketch_config() is not None
    backend = MeshBackend(StoreConfig(rows=1, slots=16), devices=CPU8, buckets=(64, 256),
                          sketch=SketchConfig(rows=4, width=1 << 12))
    assert backend.sketch_enabled

    async def run():
        import gubernator_tpu_torch.serve.promoter as prom_mod

        inst = Instance(conf, backend)
        inst.start()
        await inst.set_peers([PeerInfo(address=ADDR, is_owner=True)])
        try:
            assert inst.promoter is not None
            inst.promoter.tracker._next = 0.0
            orig = prom_mod.OBSERVE_MIN_INTERVAL_S
            prom_mod.OBSERVE_MIN_INTERVAL_S = 0.0
            try:
                reqs = [RateLimitReq(name="mp", unique_key=f"mk{j}", hits=1, limit=2,
                                     duration=600_000) for j in range(160)]
                for _ in range(4):
                    await inst.get_rate_limits(reqs)
            finally:
                prom_mod.OBSERVE_MIN_INTERVAL_S = orig
            assert backend.stats()["dropped"] > 0
            await inst.promoter.flush_once()
            st = inst.promoter.stats()
            assert st["promotions"] > 0, st
            promoted = np.array(sorted(inst.promoter._promoted), np.uint64)
            assert backend.engine.live_mask(promoted).any()
        finally:
            await inst.stop()

    asyncio.run(run())


# -- GLOBAL on the mesh -------------------------------------------------------------


def test_apply_global_hits_matches_sequential_and_installs_replicas():
    """Owner charge + combine + replica install: the flat engine's
    sequential decide, the JAX mesh's answers and store bytes, and every
    shard answers later non-owner (gnp) reads from its replica."""
    flat = TorchEngine(StoreConfig(rows=4, slots=1 << 10), buckets=(64,), device="cpu")
    mesh = MeshEngine(StoreConfig(rows=4, slots=1 << 10), devices=CPU8, buckets=(64,))
    jmesh = JMeshEngine(JStoreConfig(rows=4, slots=1 << 10), buckets=(64,))
    n = 24
    kh = (np.arange(1, n + 1, dtype=np.uint64) << np.uint64(32)) | np.uint64(11)
    assert len(set(owner_of_np(kh, mesh.n).tolist())) > 2
    hits = (np.arange(n, dtype=np.int64) % 5) + 1
    lim = np.full(n, 10, np.int64)
    dur = np.full(n, 60_000, np.int64)
    for now in (T0, T0 + 5):
        rf = flat.apply_global_hits(kh, hits, lim, dur, now)
        same_out(rf, mesh.apply_global_hits(kh, hits, lim, dur, now), f"{now}")
        same_out(rf, jmesh.apply_global_hits(kh, hits, lim, dur, now), f"{now} jax")
    np.testing.assert_array_equal(rf[2], np.maximum(10 - 2 * hits, 0))
    np.testing.assert_array_equal(mesh.store_numpy(), np.asarray(jmesh.store.data))
    args = (kh, np.zeros(n, np.int64), lim, dur, np.zeros(n, np.int32), np.ones(n, bool),
            T0 + 6)
    peek = mesh.decide_arrays(*args)
    same_out(peek, jmesh.decide_arrays(*args))
    np.testing.assert_array_equal(np.asarray(peek[2], np.int64), rf[2])
    assert mesh.gossip_chunks == mesh.install_chunks == 2  # one step a call
    assert mesh.stats.snapshot()["batches"] == 1  # gossip is not traffic


def test_replication_snapshot_surface_on_mesh(monkeypatch):
    """The replication snapshot read on the mesh backend: token windows
    snapshot as the flat backend's and the JAX mesh backend's."""
    from gubernator_tpu.api.types import RateLimitReq as JReq
    from gubernator_tpu.serve.backends import MeshBackend as JMeshBackend

    pin_hash(monkeypatch, "blake2b")
    flat = TorchBackend(StoreConfig(rows=4, slots=256), buckets=(64,), device="cpu")
    mesh = MeshBackend(StoreConfig(rows=4, slots=256), devices=CPU8, buckets=(64,))
    jmesh = JMeshBackend(JStoreConfig(rows=4, slots=256), devices=jax.devices(),
                         buckets=(64,))
    assert mesh.snapshot_read is not None
    reqs = [RateLimitReq(name="snap", unique_key=f"s{i}", hits=2, limit=9,
                         duration=60_000) for i in range(12)]
    flat.engine.get_rate_limits(reqs, now=T0)
    mesh.decide(reqs, [False] * 12, now=T0)
    jmesh.decide([JReq(name=r.name, unique_key=r.unique_key, hits=2, limit=9,
                       duration=60_000) for r in reqs], [False] * 12, now=T0)
    keys = [r.hash_key() for r in reqs] + ["never-seen"]
    a = flat.snapshot_read(keys, now=T0 + 1)
    assert a == mesh.snapshot_read(keys, now=T0 + 1) == jmesh.snapshot_read(keys, now=T0 + 1)
    assert a[-1] is None and a[0] == (9, 60_000, 7, T0 + 60_000, False)


def test_flat_sync_chunks_above_ladder_top():
    """Gossip above max(buckets): the flat engine chunks through its
    ladder, the mesh extends its own (one step), and flat, mesh and the
    JAX mesh stay decision-identical across the chunk boundary."""
    flat = TorchEngine(StoreConfig(rows=8, slots=1 << 11), buckets=(64,), device="cpu")
    mesh = MeshEngine(StoreConfig(rows=8, slots=1 << 11), devices=CPU8, buckets=(64,))
    jmesh = JMeshEngine(JStoreConfig(rows=8, slots=1 << 11), buckets=(64,))
    rng = np.random.default_rng(0xC0DE)
    n = 150
    kh = rng.integers(1, 2**63, n, np.int64).astype(np.uint64)
    ones = np.ones(n, np.int64)
    lim, dur = ones * 5, ones * 60_000
    rf = flat.apply_global_hits(kh, ones, lim, dur, T0)
    same_out(rf, mesh.apply_global_hits(kh, ones, lim, dur, T0))
    same_out(rf, jmesh.apply_global_hits(kh, ones, lim, dur, T0))
    np.testing.assert_array_equal(np.asarray(rf[2], np.int64), np.full(n, 4))
    assert flat.gossip_chunks == 3 and mesh.gossip_chunks == 1
    for e in (flat, mesh, jmesh):
        e.sync_globals(kh, lim, dur, T0 + 5)
    np.testing.assert_array_equal(mesh.store_numpy(), np.asarray(jmesh.store.data))
