"""The port's bucket replication (serve/replication.py) on the CPU: the
cases of tests/test_replication.py with the port in place of the JAX
package, the JAX package as the twin in each differential.

Successor placement, non-mutating snapshot reads (the host LRU's peek, the
exact backend's and the engine's snapshot_read, the engine's held against
the JAX engine's rows), the standby table (LWW + bounds), takeover seeding,
reconcile handback, the amnesia cycle over real gRPC (two port nodes, and a
port successor beside a JAX owner over the same ReplicateBuckets wire), the
GLOBAL backlog bound, the supervisor's backoff reset, and the ON == OFF
identity: a replication-ON port Instance answers exactly as the OFF one
and as the JAX package's ON twin, on the exact backend and on
TorchBackend(device="cpu"). Flushes are driven by explicit calls.
"""

import asyncio

import grpc
import numpy as np
import pytest

from gubernator_tpu_torch.api.grpc_glue import add_peers_servicer
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    PeerInfo,
    RateLimitReq,
    Status,
    millisecond_now,
)
from gubernator_tpu_torch.core.cache import LRUCache
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.backends import ExactBackend, TorchBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance
from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient
from gubernator_tpu_torch.serve.replication import ReplicationManager, Snapshot
from test_torch_hash import pin_hash

ADDR = "127.0.0.1:1"

T0 = 1_700_000_000_000


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self) -> int:
        return self.t


def _req(key, hits=1, limit=5, duration=60_000, algo=Algorithm.TOKEN_BUCKET,
         behavior=Behavior.BATCHING):
    return RateLimitReq(
        name="repl", unique_key=key, hits=hits, limit=limit,
        duration=duration, algorithm=algo, behavior=behavior,
    )


def _snap(key, remaining=0, reset_time=None, limit=5, duration=60_000,
          status=Status.OVER_LIMIT, snapshot_ms=None, now=None):
    now = millisecond_now() if now is None else now
    return Snapshot(
        key=key, algorithm=int(Algorithm.TOKEN_BUCKET), limit=limit,
        duration=duration, remaining=remaining,
        reset_time=now + 60_000 if reset_time is None else reset_time,
        status=int(status),
        snapshot_ms=now if snapshot_ms is None else snapshot_ms,
    )


def _counter(metric, **labels) -> float:
    m = metric.labels(**labels) if labels else metric
    return m._value.get()


# -- ring successor --------------------------------------------------------


def _picker(hosts):
    p = ConsistentHashPicker()
    for h in hosts:
        p.add(PeerClient(BehaviorConfig(), h))
    return p


def test_get_successor_is_ring_owner_without_current_owner():
    hosts = [f"10.0.0.{i}:81" for i in range(1, 6)]
    p = _picker(hosts)
    for i in range(200):
        key = f"repl_s{i}"
        owner = p.get(key)
        succ = p.get_successor(key)
        assert succ is not None and succ.host != owner.host
        # the defining property: the successor is exactly where the
        # ring routes this key once the owner is gone
        without = _picker([h for h in hosts if h != owner.host])
        assert succ.host == without.get(key).host


def test_get_successor_single_host_is_none():
    p = _picker(["10.0.0.1:81"])
    assert p.get_successor("any_key") is None


# -- non-mutating snapshot reads -------------------------------------------


def test_lru_peek_is_non_mutating():
    c = LRUCache(2)
    c.add("a", 1, T0 + 1000)
    c.add("b", 2, T0 + 1000)
    s0 = c.stats()
    assert c.peek("a", T0) == (1, True)
    assert c.peek("missing", T0) == (None, False)
    assert c.peek("b", T0 + 2000) == (None, False)  # expired: not deleted
    s1 = c.stats()
    assert (s1.hit, s1.miss, s1.size) == (s0.hit, s0.miss, s0.size)
    # recency untouched: "a" (peeked last) must still be the eviction
    # victim, because peek didn't move it to the front
    c.add("c", 3, T0 + 1000)
    assert c.peek("a", T0) == (None, False)
    assert c.peek("b", T0)[1]


def test_exact_snapshot_read_rows_and_gates():
    be = ExactBackend(100)
    now = millisecond_now()
    tok = _req("t1", hits=2, limit=10)
    over = _req("t2", hits=9, limit=5)  # created over limit: sticky
    leaky = _req("l1", hits=1, algo=Algorithm.LEAKY_BUCKET)
    be.decide([tok, over, leaky], [False] * 3, now=now)
    s0 = be.stats()
    rows = be.snapshot_read(
        [tok.hash_key(), over.hash_key(), leaky.hash_key(), "repl_miss"],
        now + 5,
    )
    limit, duration, remaining, reset, is_over = rows[0]
    assert (limit, remaining, reset, is_over) == (10, 8, now + 60_000, False)
    assert duration == 0  # not persisted by the exact token window
    assert rows[1][2] == 5 and rows[1][4] is True  # sticky over
    assert rows[2] is None  # leaky out of scope
    assert rows[3] is None
    # non-mutating: hit/miss accounting untouched by the reads above
    assert be.stats() == s0


def test_engine_snapshot_read_matches_decide_and_mutates_nothing():
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    def mk():
        return TorchBackend(StoreConfig(rows=4, slots=1 << 10), buckets=(64,),
                            device="cpu")

    a, b = mk(), mk()
    now = millisecond_now()
    keys = [f"repl_d{i}" for i in range(4)]
    kh = slot_hash_batch(keys)
    hits = np.array([2, 5, 9, 1], np.int64)
    limit = np.array([10, 5, 5, 10], np.int64)
    dur = np.full(4, 60_000, np.int64)
    algo = np.array([0, 0, 0, 1], np.int32)
    gnp = np.zeros(4, bool)
    for be in (a, b):
        be.engine.decide_arrays(kh, hits, limit, dur, algo, gnp, now)
    rows = a.snapshot_read(keys, now + 10)
    assert rows[0] == (10, 60_000, 8, now + 60_000, False)
    assert rows[1] == (5, 60_000, 0, now + 60_000, True)  # exhausted
    assert rows[2][4] is True  # created-over sticky flag
    assert rows[3] is None  # leaky
    # non-mutation: the snapshotted engine keeps deciding identically
    # to its never-snapshotted twin
    ones = np.ones(4, np.int64)
    ra = a.engine.decide_arrays(kh, ones, limit, dur, algo, gnp, now + 20)
    rb = b.engine.decide_arrays(kh, ones, limit, dur, algo, gnp, now + 20)
    for x, y in zip(ra, rb):
        assert np.array_equal(x, y)


def test_engine_snapshot_read_matches_the_jax_engine(monkeypatch):
    """The same decides on the port's engine and the JAX engine (one slot
    hash): identical snapshot rows, then identical decides after them."""
    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import TpuBackend as JTpuBackend
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    pin_hash(monkeypatch, "blake2b")
    t = TorchBackend(StoreConfig(rows=4, slots=1 << 8), buckets=(64,), device="cpu")
    j = JTpuBackend(JStoreConfig(rows=4, slots=1 << 8), buckets=(64,))
    rng = np.random.default_rng(4)
    keys = [f"repl_j{i}" for i in range(48)]
    kh = slot_hash_batch(keys)
    now = T0
    for step in range(12):
        now += int(rng.choice([0, 5, 700, 30_000]))
        hits = rng.choice([0, 1, 2, 9], 48).astype(np.int64)
        limit = rng.choice([1, 5, 10], 48).astype(np.int64)
        dur = rng.choice([1000, 60_000], 48).astype(np.int64)
        algo = rng.integers(0, 4, 48).astype(np.int32)
        gnp = np.zeros(48, bool)
        ra = t.engine.decide_arrays(kh, hits, limit, dur, algo, gnp, now)
        rb = j.engine.decide_arrays(kh, hits, limit, dur, algo, gnp, now)
        for x, y in zip(ra, rb):
            assert np.array_equal(np.asarray(x), np.asarray(y)), step
        assert t.snapshot_read(keys, now + 1) == j.snapshot_read(keys, now + 1)
    assert np.array_equal(t.engine.store.data.numpy(), np.asarray(j.engine.store.data))


# -- manager tables ---------------------------------------------------------


class _DummyInstance:
    pass


def _mgr(**conf_kw) -> ReplicationManager:
    conf = ServerConfig(
        grpc_address=ADDR, advertise_address=ADDR, replication=True,
        **conf_kw,
    )
    return ReplicationManager(conf, _DummyInstance())


def test_queue_dirty_gates_and_backlog_bound():
    async def run():
        m = _mgr(replication_backlog=2)
        m.queue_dirty(_req("a", hits=0))  # peek: nothing to replicate
        m.queue_dirty(_req("b", algo=Algorithm.LEAKY_BUCKET))
        assert not m._dirty
        before = _counter(metrics.REPLICATION_DROPPED, what="dirty_backlog")
        m.queue_dirty(_req("a"))
        m.queue_dirty(_req("b"))
        m.queue_dirty(_req("c"))  # past the cap: dropped + counted
        assert sorted(m._dirty) == [
            _req("a").hash_key(), _req("b").hash_key()
        ]
        m.queue_dirty(_req("a", limit=9))  # existing key: still updates
        assert m._dirty[_req("a").hash_key()][1] == 9
        after = _counter(metrics.REPLICATION_DROPPED, what="dirty_backlog")
        assert after == before + 1

    asyncio.run(run())


def test_queue_dirty_fields_bridge_tier():
    """The edge fold's array-level dirty marking: same gates as
    queue_dirty (hits > 0, token only), bounded, last-row-wins per
    key."""
    m = _mgr(replication_backlog=2)
    keys = ["a", "b", "a", "c", "d", "e"]
    fields = dict(
        hits=np.array([1, 0, 2, 1, 1, 1], np.int64),
        limit=np.array([5, 5, 7, 5, 5, 5], np.int64),
        duration=np.full(6, 60_000, np.int64),
        algo=np.array([0, 0, 0, 1, 0, 0], np.int32),
    )
    before = _counter(metrics.REPLICATION_DROPPED, what="dirty_backlog")
    m.queue_dirty_fields(keys, fields)
    # b is a peek and c is leaky (ineligible); a repeats (last row
    # wins: limit 7); e arrives past the 2-key cap: dropped + counted
    assert sorted(m._dirty) == ["a", "d"]
    assert m._dirty["a"][1] == 7
    assert _counter(
        metrics.REPLICATION_DROPPED, what="dirty_backlog"
    ) == before + 1


def test_standby_eviction_tracks_freshness_not_first_insert():
    """At capacity the evictee must be the STALEST snapshot: a hot key
    re-replicated every window must survive the arrival of a new key
    even though it was inserted first."""

    async def run():
        m = _mgr(replication_standby_keys=2)

        class _Inst:
            def get_peer(self, key):
                raise RuntimeError("not owned")

        m.instance = _Inst()
        now = millisecond_now()
        await m.install("o:1", [_snap("hot", reset_time=now + 1000,
                                      snapshot_ms=now, now=now)])
        await m.install("o:1", [_snap("cold", reset_time=now + 1000,
                                      snapshot_ms=now, now=now)])
        # the hot key refreshes (newer window)
        await m.install("o:1", [_snap("hot", reset_time=now + 5000,
                                      snapshot_ms=now + 1, now=now)])
        # a new key arrives at capacity: "cold" (stalest) must go
        await m.install("o:1", [_snap("new", reset_time=now + 1000,
                                      snapshot_ms=now, now=now)])
        assert sorted(m._standby) == ["hot", "new"]

    asyncio.run(run())


def test_standby_lww_bound_and_pop():
    async def run():
        m = _mgr(replication_standby_keys=2)
        now = millisecond_now()

        # non-owned keys go standby (get_peer raising = not owned)
        class _Inst:
            def get_peer(self, key):
                raise RuntimeError("no ring")

        m.instance = _Inst()
        newer = _snap("k1", remaining=1, reset_time=now + 9000, now=now)
        older = _snap("k1", remaining=3, reset_time=now + 4000, now=now)
        await m.install("o:1", [newer])
        await m.install("o:1", [older])  # LWW: older loses
        assert m._standby["k1"].remaining == 1
        await m.install("o:1", [newer])  # duplicate: idempotent no-op
        assert m.standby_len == 1
        await m.install("o:1", [_snap("k2", now=now), _snap("k3", now=now)])
        assert m.standby_len == 2  # bounded: oldest evicted
        # expired snapshots are refused outright
        await m.install("o:1", [_snap("k4", reset_time=now - 1, now=now)])
        assert "k4" not in m._standby
        # pop is one-shot and expiry-gated
        assert m.standby_pop("k3") is not None
        assert m.standby_pop("k3") is None
        m._standby["k5"] = _snap("k5", reset_time=millisecond_now() - 1)
        assert m.standby_pop("k5") is None

    asyncio.run(run())


# -- instance integration ---------------------------------------------------


def _conf(**kw) -> ServerConfig:
    conf = ServerConfig(
        grpc_address=ADDR,
        advertise_address=ADDR,
        backend="exact",
        replication=True,
        replication_sync_wait=60.0,  # flushes driven manually
        behaviors=BehaviorConfig(
            peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3,
            breaker_cooldown=0.2,
        ),
    )
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


async def _instance(conf=None, backend=None) -> Instance:
    conf = conf or _conf()
    inst = Instance(conf, backend if backend is not None else ExactBackend(1000))
    inst.start()
    await inst.set_peers([PeerInfo(address=conf.advertise_address,
                                   is_owner=True)])
    return inst


def test_replication_refused_without_snapshot_surface():
    class _NoSnap:
        inline_decide = True

        def decide(self, reqs, gnp, now=None):  # pragma: no cover
            return []

    with pytest.raises(ValueError, match="snapshot_read"):
        Instance(_conf(), _NoSnap())


def test_reconcile_install_continues_window_on_owner():
    """A snapshot received for a key THIS node owns (the handback from
    its interim successor) installs straight into the store: the next
    decide continues the replicated window, not a fresh one."""

    async def run():
        inst = await _instance()
        try:
            key = _req("own1").hash_key()
            now = millisecond_now()
            await inst.repl.install(
                "succ:1",
                [_snap(key, remaining=1, reset_time=now + 30_000,
                       status=Status.UNDER_LIMIT, now=now)],
            )
            assert inst.repl.standby_len == 0  # not parked: installed
            r = (await inst.get_rate_limits([_req("own1", hits=1)]))[0]
            # continuation proof: remaining 1 -> 0 under the replicated
            # reset_time; a fresh window would be remaining=4 with a
            # new reset
            assert r.remaining == 0 and r.reset_time == now + 30_000
        finally:
            await inst.stop()

    asyncio.run(run())


async def _two_peer_instance(conf):
    """This node + a dead peer; returns (inst, dead_addr, dead_keys)."""
    from tests._util import free_ports

    dead = f"127.0.0.1:{free_ports(1)[0]}"
    inst = Instance(conf, ExactBackend(1000))
    inst.start()
    await inst.set_peers([
        PeerInfo(address=conf.advertise_address, is_owner=True),
        PeerInfo(address=dead, is_owner=False),
    ])
    keys = [f"dk{i}" for i in range(256)
            if inst.get_peer(_req(f"dk{i}").hash_key()).host == dead]
    assert keys, "no key landed on the dead peer"
    return inst, dead, keys


def test_takeover_seeds_standby_and_stamps_metadata():
    async def run():
        inst, dead, keys = await _two_peer_instance(_conf())
        try:
            key = _req(keys[0]).hash_key()
            now = millisecond_now()
            before = _counter(metrics.REPLICATED_TAKEOVERS)
            await inst.repl.install(
                dead, [_snap(key, remaining=0, reset_time=now + 30_000)]
            )
            assert inst.repl.standby_len == 1
            r = (await inst.get_rate_limits([_req(keys[0], hits=1)]))[0]
            # the dead owner's frozen refusal survived: no quota amnesia
            assert r.error == ""
            assert r.status == Status.OVER_LIMIT
            assert r.remaining == 0 and r.reset_time == now + 30_000
            assert r.metadata["replicated"] == "true"
            assert r.metadata["owner"] == ADDR  # the successor answered
            assert _counter(metrics.REPLICATED_TAKEOVERS) == before + 1
            # seeded key is tracked for the handback on owner return
            assert key in inst.repl._taken
            assert inst.repl.standby_len == 0
            # an UN-replicated dead-owner key still gets a successor
            # answer (fresh window), also stamped
            r2 = (await inst.get_rate_limits([_req(keys[1], hits=1)]))[0]
            assert r2.error == "" and r2.metadata["replicated"] == "true"
            assert r2.status == Status.UNDER_LIMIT
        finally:
            await inst.stop()

    asyncio.run(run())


def test_update_peer_globals_purges_standby():
    async def run():
        inst, dead, keys = await _two_peer_instance(_conf())
        try:
            key = _req(keys[0]).hash_key()
            await inst.repl.install(dead, [_snap(key)])
            assert inst.repl.standby_len == 1
            # the owner broadcasting status for the key supersedes the
            # replicated snapshot (reconcile contract)
            from gubernator_tpu_torch.api.types import RateLimitResp

            await inst.update_peer_globals(
                [(key, RateLimitResp(limit=5, remaining=5,
                                     reset_time=millisecond_now() + 1000))]
            )
            assert inst.repl.standby_len == 0
        finally:
            await inst.stop()

    asyncio.run(run())


# -- full amnesia cycle over real gRPC --------------------------------------


def _owner_stack(pkg):
    """(Instance, ExactBackend, PeerInfo, conf maker, PeersV1Servicer,
    add_peers_servicer) of the owner node's package."""
    if pkg == "torch":
        from gubernator_tpu_torch.serve.server import PeersV1Servicer

        return (Instance, ExactBackend, PeerInfo, _conf, PeersV1Servicer,
                add_peers_servicer)
    from gubernator_tpu.api.grpc_glue import add_peers_servicer as j_add
    from gubernator_tpu.api.types import PeerInfo as JPeerInfo
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend
    from gubernator_tpu.serve.instance import Instance as JInstance
    from gubernator_tpu.serve.server import PeersV1Servicer as JServicer

    return JInstance, JExactBackend, JPeerInfo, _jax_conf, JServicer, j_add


@pytest.mark.parametrize("owner_pkg", ["torch", "jax"])
def test_amnesia_cycle_kill_takeover_restart_reconcile(owner_pkg):
    """The tentpole end-to-end, in-process: drive a key over-limit on
    its owner, kill the owner, assert the successor answers OVER_LIMIT
    from the replicated snapshot, restart the owner with a FRESH store
    (quota amnesia), hand back, and assert the key is still over-limit
    on the reborn owner. The successor A is the port's; the owner B is
    the port's or the JAX package's (the ReplicateBuckets wire, the
    snapshot and the handback cross the two packages)."""
    from tests._util import free_ports
    from gubernator_tpu_torch.serve.server import PeersV1Servicer

    BInstance, BExact, BPeerInfo, b_conf, BServicer, b_add = _owner_stack(owner_pkg)

    async def serve(inst, addr, servicer=PeersV1Servicer, add=add_peers_servicer):
        server = grpc.aio.server()
        add(server, servicer(inst))
        assert server.add_insecure_port(addr) != 0
        await server.start()
        return server

    async def run():
        pa, pb = free_ports(2)
        addr_a, addr_b = f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"

        def conf_for(me, mk=_conf):
            c = mk()
            c.grpc_address = me
            c.advertise_address = me
            return c

        async def boot_b():
            inst = BInstance(conf_for(addr_b, b_conf), BExact(1000))
            inst.start()
            await inst.set_peers([BPeerInfo(address=addr_a, is_owner=False),
                                  BPeerInfo(address=addr_b, is_owner=True)])
            return inst, await serve(inst, addr_b, BServicer, b_add)

        a = Instance(conf_for(addr_a), ExactBackend(1000))
        a.start()
        await a.set_peers([PeerInfo(address=addr_a, is_owner=True),
                           PeerInfo(address=addr_b, is_owner=False)])
        srv_a = await serve(a, addr_a)
        b, srv_b = await boot_b()

        srv_b2 = b2 = None
        try:
            # a key B owns, driven over-limit THROUGH A (forwarded)
            bkey = next(
                f"bk{i}" for i in range(256)
                if a.get_peer(_req(f"bk{i}").hash_key()).host == addr_b
            )
            r = (await a.get_rate_limits([_req(bkey, hits=9, limit=5)]))[0]
            assert r.error == "" and r.status == Status.OVER_LIMIT
            assert r.metadata["owner"] == addr_b

            # owner flushes its dirty window to the successor (A)
            await b.repl.flush_once()
            assert a.repl.standby_len == 1

            # SIGKILL analogue: B's listener vanishes mid-flight
            await srv_b.stop(None)
            await b.stop()

            r = (await a.get_rate_limits([_req(bkey, hits=1, limit=5)]))[0]
            assert r.error == ""
            assert r.status == Status.OVER_LIMIT, (
                "quota amnesia: the successor forgot the dead owner's "
                "over-limit window"
            )
            assert r.metadata["replicated"] == "true"

            # owner restarts with a FRESH store on the same address
            b2, srv_b2 = await boot_b()

            # reconcile: A hands the interim window back (retried every
            # flush tick; the breaker may need its cooldown first)
            deadline = asyncio.get_running_loop().time() + 5.0
            while a.repl._taken:
                await a.repl.flush_once()
                if asyncio.get_running_loop().time() > deadline:
                    raise AssertionError("handback never landed")
                await asyncio.sleep(0.05)

            # the reborn owner answers from the handed-back window:
            # STILL over-limit, no amnesia across the restart
            r = (await b2.get_rate_limits([_jax_req(_req(bkey, hits=1, limit=5))
                                           if owner_pkg == "jax"
                                           else _req(bkey, hits=1, limit=5)]))[0]
            assert r.error == "" and int(r.status) == int(Status.OVER_LIMIT)
            # and through A (forwarded to the returned owner)
            r = (await a.get_rate_limits([_req(bkey, hits=1, limit=5)]))[0]
            assert r.error == "" and r.status == Status.OVER_LIMIT
            assert r.metadata["owner"] == addr_b
            assert "replicated" not in r.metadata
        finally:
            await srv_a.stop(None)
            if srv_b2 is not None:
                await srv_b2.stop(None)
            await a.stop()
            if b2 is not None:
                await b2.stop()

    asyncio.run(run())


# -- differential identity: replication ON == OFF without failures ----------


def _pin_clock(monkeypatch, clock):
    """One pinned clock for both packages (the JAX twin included) and
    both on one slot hash."""
    import gubernator_tpu.api.types as j_types
    import gubernator_tpu.core.engine as j_engine
    import gubernator_tpu.core.oracle as j_oracle
    import gubernator_tpu.serve.replication as j_repl
    import gubernator_tpu_torch.api.types as types_mod
    import gubernator_tpu_torch.core.oracle as oracle_mod
    import gubernator_tpu_torch.serve.replication as repl_mod

    for mod in (types_mod, oracle_mod, repl_mod, j_types, j_engine, j_oracle, j_repl):
        monkeypatch.setattr(mod, "millisecond_now", clock)
    pin_hash(monkeypatch, "blake2b")


def _assert_same(a, b, ctx):
    assert (
        a.status, a.limit, a.remaining, a.reset_time, a.error, a.metadata
    ) == (
        b.status, b.limit, b.remaining, b.reset_time, b.error, b.metadata
    ), (ctx, a, b)


def _fuzz_stream(rng, keys, steps):
    for step in range(steps):
        n = int(rng.integers(1, 7))
        batch = []
        for _ in range(n):
            k = int(rng.integers(len(keys)))
            batch.append(RateLimitReq(
                name="replfuzz",
                unique_key=keys[k],
                hits=int(rng.choice([0, 1, 1, 1, 2, 9])),
                limit=int(rng.choice([1, 1, 2, 3, 50])),
                duration=int(rng.choice([400, 2000, 60_000])),
                algorithm=Algorithm(k % 2),
            ))
        yield step, batch, int(rng.choice([0, 0, 1, 7, 150, 500, 2500]))


def _jax_req(r):
    """The JAX package's twin of a port RateLimitReq (no chain)."""
    from gubernator_tpu.api import types as jt

    return jt.RateLimitReq(
        name=r.name, unique_key=r.unique_key, hits=r.hits, limit=r.limit,
        duration=r.duration, algorithm=jt.Algorithm(int(r.algorithm)),
        behavior=jt.Behavior(int(r.behavior)),
    )


def _jax_conf(**kw):
    from gubernator_tpu.serve.config import BehaviorConfig as JB
    from gubernator_tpu.serve.config import ServerConfig as JS

    conf = JS(
        grpc_address=ADDR, advertise_address=ADDR, backend="exact",
        replication=True, replication_sync_wait=60.0,
        behaviors=JB(
            peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3,
            breaker_cooldown=0.2,
        ),
    )
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


def _final_state(inst):
    be = inst.backend
    if hasattr(be, "engine"):
        eng = be.engine  # the port's engines (flat or mesh) or a JAX one
        data = eng.store_numpy() if hasattr(eng, "store_numpy") else eng.store.data
        return np.asarray(data).tobytes()
    return [(k, rec.expire_at, repr(rec.value)) for k, rec in be.cache._data.items()]


async def _fuzz_pair(mk_backend, mk_jax_backend, clock, steps, seed):
    """ON and OFF port twins plus the JAX package's ON twin: identical
    ring (self + a dead successor so the flush loop really snapshots and
    sends), only the knob (or the package) differs. Only self-owned keys
    are driven: the no-failure contract."""
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.serve.instance import Instance as JInstance
    from tests._util import free_ports

    # a 2-point crc32 ring can split very lopsidedly; re-roll the dead
    # successor's port until this node owns a workable share of the
    # fuzz key space (no flaky splits)
    def owned(dead_addr, count=200):
        picker = ConsistentHashPicker()
        me = PeerClient(BehaviorConfig(), ADDR, is_owner=True)
        picker.add(me)
        picker.add(PeerClient(BehaviorConfig(), dead_addr))
        return [
            f"f{i}" for i in range(count)
            if picker.get(
                RateLimitReq(name="replfuzz", unique_key=f"f{i}").hash_key()
            ) is me
        ]

    for port in free_ports(16):
        dead = f"127.0.0.1:{port}"
        keys = owned(dead)[:12]
        if len(keys) >= 8:
            break
    assert len(keys) >= 8, "no workable ring split in 16 rolls"

    async def mk(repl):
        conf = _conf(replication=repl)
        inst = Instance(conf, mk_backend())
        inst.start()
        await inst.set_peers([
            PeerInfo(address=ADDR, is_owner=True),
            PeerInfo(address=dead, is_owner=False),
        ])
        return inst

    on = await mk(True)
    off = await mk(False)
    twin = JInstance(_jax_conf(), mk_jax_backend())
    twin.start()
    await twin.set_peers([
        jt.PeerInfo(address=ADDR, is_owner=True),
        jt.PeerInfo(address=dead, is_owner=False),
    ])
    for inst in (on, off, twin):
        if inst.shed is not None:
            inst.shed.now_fn = clock
    for k in keys:
        req = RateLimitReq(name="replfuzz", unique_key=k)
        assert on.get_peer(req.hash_key()).is_owner
    try:
        rng = np.random.default_rng(seed)
        snapshotted = 0
        for step, batch, dt in _fuzz_stream(rng, keys, steps):
            clock.t += dt
            a = await on.get_rate_limits(batch)
            b = await off.get_rate_limits(batch)
            c = await twin.get_rate_limits([_jax_req(r) for r in batch])
            for x, y, z, r in zip(a, b, c, batch):
                _assert_same(x, y, (step, r))
                _assert_same(x, z, (step, r, "jax"))
            if step % 25 == 24:
                snapshotted += len(on.repl._dirty)
                assert sorted(on.repl._dirty.items()) == sorted(twin.repl._dirty.items())
                await on.repl.flush_once()
                await twin.repl.flush_once()
        assert snapshotted > 0, "fuzz never flushed a dirty window"
        assert _final_state(on) == _final_state(off)
        if hasattr(on.backend, "engine"):
            assert _final_state(on) == _final_state(twin)
    finally:
        await on.stop()
        await off.stop()
        await twin.stop()


@pytest.mark.parametrize("seed", [3, 11])
def test_differential_identity_fuzz_exact(monkeypatch, seed):
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend

    clock = FakeClock()
    _pin_clock(monkeypatch, clock)
    asyncio.run(_fuzz_pair(
        lambda: ExactBackend(10_000), lambda: JExactBackend(10_000),
        clock, 250, seed,
    ))


def test_differential_identity_fuzz_device(monkeypatch):
    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import TpuBackend as JTpuBackend

    clock = FakeClock()
    _pin_clock(monkeypatch, clock)

    def be():
        return TorchBackend(StoreConfig(rows=16, slots=1 << 10),
                            buckets=(16, 64), device="cpu")

    def jbe():
        return JTpuBackend(JStoreConfig(rows=16, slots=1 << 10), buckets=(16, 64))

    asyncio.run(_fuzz_pair(be, jbe, clock, 100, 5))


# -- satellites: GLOBAL backlog bound + supervisor backoff reset ------------


def test_global_manager_backlog_bound():
    from gubernator_tpu_torch.serve.global_mgr import GlobalManager

    async def run():
        mgr = GlobalManager(BehaviorConfig(global_backlog=2), None)
        before_h = _counter(metrics.GLOBAL_BACKLOG_DROPPED, queue="hits")
        before_u = _counter(metrics.GLOBAL_BACKLOG_DROPPED, queue="updates")
        g = Behavior.GLOBAL
        mgr.queue_hit(_req("a", hits=1, behavior=g))
        mgr.queue_hit(_req("b", hits=2, behavior=g))
        mgr.queue_hit(_req("c", hits=3, behavior=g))  # new key: dropped
        assert len(mgr._hits) == 2
        # existing keys keep aggregating at the cap
        mgr.queue_hit(_req("a", hits=5, behavior=g))
        assert mgr._hits[_req("a").hash_key()].hits == 6
        mgr.queue_update(_req("a", behavior=g))
        mgr.queue_update(_req("b", behavior=g))
        mgr.queue_update(_req("c", behavior=g))  # dropped
        mgr.queue_update(_req("b", behavior=g))  # existing: refreshed
        assert len(mgr._updates) == 2
        assert _counter(
            metrics.GLOBAL_BACKLOG_DROPPED, queue="hits"
        ) == before_h + 1
        assert _counter(
            metrics.GLOBAL_BACKLOG_DROPPED, queue="updates"
        ) == before_u + 1

    asyncio.run(run())


def test_supervise_resets_backoff_after_long_healthy_run(monkeypatch):
    """A loop that dies after a run longer than SUPERVISE_RESET_S must
    restart at the BASE backoff, not the escalated one (previously
    untested: a one-off crash after days of health was penalized like a
    crash loop)."""
    from gubernator_tpu_torch.serve import global_mgr

    class _TimeShim:
        def __init__(self):
            self.t = 0.0

        def monotonic(self):
            return self.t

    class _AsyncioShim:
        CancelledError = asyncio.CancelledError

        def __init__(self):
            self.sleeps = []

        async def sleep(self, d):
            self.sleeps.append(d)

    tshim, ashim = _TimeShim(), _AsyncioShim()
    monkeypatch.setattr(global_mgr, "time", tshim)
    monkeypatch.setattr(global_mgr, "asyncio", ashim)

    calls = [0]

    async def loop_factory():
        calls[0] += 1
        if calls[0] <= 2:
            raise RuntimeError(f"fast crash {calls[0]}")
        if calls[0] == 3:
            # a long healthy run, then a one-off death
            tshim.t += global_mgr.SUPERVISE_RESET_S + 1.0
            raise RuntimeError("one-off after health")
        raise asyncio.CancelledError

    async def run():
        with pytest.raises(asyncio.CancelledError):
            await global_mgr.supervise("test_loop", loop_factory)

    asyncio.run(run())
    base = global_mgr.SUPERVISE_BACKOFF_S
    assert ashim.sleeps[0] == base  # first crash: base
    assert ashim.sleeps[1] == 2 * base  # crash loop: escalates
    assert ashim.sleeps[2] == base, (
        "backoff must reset to base after a healthy run longer than "
        "SUPERVISE_RESET_S"
    )
