"""The port's elastic ring rescale (serve/rescale.py) on the CPU: the
cases of tests/test_rescale.py with the port in place of the JAX package
with its three mesh cases on the port's MeshEngine (8 CPU shards against
the JAX package's 8 simulated devices), the JAX package as the twin in
each differential.

ownership_diff ring semantics, the tracked/pending tables, double-serve
routing, the ON == OFF identity through the real serving pipeline (the
port's ON Instance also answering exactly as the JAX package's ON twin, on
the exact backend and on TorchBackend(device="cpu")), an in-process
add-node/remove-node handoff cycle over real gRPC (a tracked over-limit
key never under-admits), the ring-flip-mid-flush replication fix, the
post-reshuffle standby purge; and the engine's full-store export and flat
repartition held against the JAX engine's on the same decides: identical
export columns in store order, identical store bytes after the move.
"""

import asyncio

import grpc
import numpy as np
import pytest

from gubernator_tpu_torch.api.grpc_glue import add_peers_servicer
from gubernator_tpu_torch.api.types import (
    Algorithm,
    PeerInfo,
    RateLimitReq,
    Status,
    millisecond_now,
)
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.backends import ExactBackend, TorchBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance
from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient
from gubernator_tpu_torch.serve.rescale import RescaleManager

from test_torch_hash import pin_hash
from test_torch_replication import (  # noqa: F401 (shared rig)
    FakeClock,
    _assert_same,
    _final_state,
    _fuzz_stream,
    _jax_req,
    _pin_clock,
    _snap,
)

ADDR = "127.0.0.1:1"
T0 = 1_700_000_000_000


def _req(key, hits=1, limit=5, duration=60_000,
         algo=Algorithm.TOKEN_BUCKET):
    return RateLimitReq(
        name="resc", unique_key=key, hits=hits, limit=limit,
        duration=duration, algorithm=algo,
    )


def _picker(hosts, me=None):
    p = ConsistentHashPicker()
    for h in hosts:
        p.add(PeerClient(BehaviorConfig(), h, is_owner=(h == me)))
    return p


def _counter(metric, **labels) -> float:
    m = metric.labels(**labels) if labels else metric
    return m._value.get()


# -- ownership_diff ---------------------------------------------------------


def test_ownership_diff_pins_ring_semantics():
    """The diff is exactly the set of self-owned keys the new ring
    routes elsewhere, grouped by their NEW owner — and the new owner is
    the new ring's get(), nothing else."""
    me = "10.0.0.1:81"
    hosts = [f"10.0.0.{i}:81" for i in range(1, 5)]
    old = _picker(hosts, me=me)
    keys = [f"od{i}" for i in range(400)]
    # crc32 placement: not every joining host cuts THIS node's arc —
    # roll candidate joiners until one takes over part of it
    for j in range(9, 40):
        new = _picker(hosts[:3] + [f"10.0.0.{j}:81"], me=me)
        if old.ownership_diff(new, keys):
            break
    diff = old.ownership_diff(new, keys)
    moved = {k for _, (_, ks) in diff.items() for k in ks}
    for k in keys:
        owned_old = old.get(k).is_owner
        new_owner = new.get(k)
        if owned_old and not new_owner.is_owner:
            assert k in moved
            assert k in dict([
                (kk, None) for kk in diff[new_owner.host][1]
            ])
        else:
            assert k not in moved
    assert moved, "no key moved in 400 draws — ring fixture broken"
    # the grouped client IS the new picker's client for that host
    for host, (peer, _ks) in diff.items():
        assert peer is new.get_peer_by_host(host)
    # identical rings diff to nothing
    assert old.ownership_diff(old, keys) == {}
    # empty rings diff to nothing rather than raising
    assert ConsistentHashPicker().ownership_diff(new, keys) == {}
    assert old.ownership_diff(ConsistentHashPicker(), keys) == {}


# -- manager tables ---------------------------------------------------------


class _DummyInstance:
    pass


def _mgr(**conf_kw) -> RescaleManager:
    conf = ServerConfig(
        grpc_address=ADDR, advertise_address=ADDR, rescale=True,
        **conf_kw,
    )
    return RescaleManager(conf, _DummyInstance())


def test_note_owned_gates_and_freshest_kept_eviction():
    m = _mgr(rescale_track_keys=2)
    m.note_owned(_req("a", hits=0))  # peek: cannot create a window
    m.note_owned(_req("b", algo=Algorithm.LEAKY_BUCKET))  # out of scope
    assert m.tracked_len == 0
    before = _counter(metrics.RESCALE_DROPPED, what="track_evict")
    m.note_owned(_req("a"))
    m.note_owned(_req("b"))
    m.note_owned(_req("a", limit=9))  # re-touch refreshes (limit 9)
    m.note_owned(_req("c"))  # at capacity: "b" (stalest touch) evicts
    assert sorted(m._tracked) == sorted(
        [_req("a").hash_key(), _req("c").hash_key()]
    )
    assert m._tracked[_req("a").hash_key()][1] == 9
    assert _counter(
        metrics.RESCALE_DROPPED, what="track_evict"
    ) == before + 1


def test_note_owned_fields_bridge_tier():
    m = _mgr()
    keys = ["a", "b", "c", "d"]
    fields = dict(
        hits=np.array([1, 0, 2, 1], np.int64),
        limit=np.array([5, 5, 7, 5], np.int64),
        duration=np.full(4, 60_000, np.int64),
        algo=np.array([0, 0, 0, 1], np.int32),
    )
    m.note_owned_fields(keys, fields)
    # b is a peek and d is leaky: ineligible
    assert sorted(m._tracked) == ["a", "c"]
    assert m._tracked["c"][1] == 7


def test_pending_install_lww_bound_pop_and_purge():
    async def run():
        m = _mgr(rescale_track_keys=2)

        class _Inst:
            def get_peer(self, key):
                raise RuntimeError("not owned")

        m.instance = _Inst()
        now = millisecond_now()
        newer = _snap("k1", remaining=1, reset_time=now + 9000, now=now)
        older = _snap("k1", remaining=3, reset_time=now + 4000, now=now)
        await m.install("o:1", [newer])
        await m.install("o:1", [older])  # LWW: older loses
        assert m._pending["k1"].remaining == 1
        await m.install("o:1", [newer])  # duplicate: idempotent no-op
        assert m.pending_len == 1
        await m.install("o:1", [_snap("k2", now=now),
                                _snap("k3", now=now)])
        assert m.pending_len == 2  # bounded: stalest evicted
        # expired snapshots are refused outright
        await m.install("o:1", [_snap("k4", reset_time=now - 1, now=now)])
        assert "k4" not in m._pending
        # pop is one-shot and expiry-gated
        assert m.pending_pop("k3") is not None
        assert m.pending_pop("k3") is None
        # an owner broadcast supersedes a parked handoff
        await m.install("o:1", [_snap("k5", now=now)])
        m.pending_purge(["k5"])
        assert m.pending_pop("k5") is None

    asyncio.run(run())


def test_route_override_double_serve_window():
    me = "10.0.0.1:81"
    hosts = [f"10.0.0.{i}:81" for i in range(1, 5)]
    old = _picker(hosts, me=me)
    new = _picker(hosts[:3] + ["10.0.0.9:81"], me=me)
    m = _mgr(rescale_double_serve=60.0)
    m.note_ring_change(old, new)
    keys = [f"ov{i}" for i in range(300)]
    routed = local = 0
    for k in keys:
        r = _req(k, hits=0)
        ov = m.route_override(k, r)
        o, n = old.get(k), new.get(k)
        if o.host == n.host or n.is_owner:
            assert ov is None  # unmoved, or we ARE the new owner
        elif o.is_owner:
            # this node is the OLD owner: serve locally (the returned
            # client is the live self client) and count + re-dirty
            assert ov is o and ov.is_owner
            local += 1
        elif o.host not in {p.host for p in new.peers()}:
            assert ov is None  # old owner left the ring: no stand-in
        else:
            assert ov is not None and ov.host == o.host
            routed += 1
    assert routed, "no moved key in 300 draws — ring fixture broken"
    # a closed window stops overriding and retires the transition
    m._transition = (old, new, 0.0)
    assert m.route_override(keys[0], _req(keys[0])) is None
    assert m._transition is None


def test_failed_reconcile_retries_until_delivered():
    """A moved key whose handoff send FAILS for the whole double-serve
    window must stay in the moved/tracked tables and keep retrying
    every tick — dropping it would strand the window on this node
    forever (a later ring change's diff cannot re-move it), the exact
    amnesia the subsystem exists to prevent."""

    async def run():
        m = _mgr(rescale_double_serve=0.0)  # window already closed
        key = "stranded"
        reset = millisecond_now() + 60_000

        class _Peer:
            host = "10.0.0.2:81"
            is_owner = False
            fail = True
            sent = []

            async def replicate_buckets(self, snaps, owner=""):
                if self.fail:
                    raise ConnectionError("door not ready")
                self.sent.extend(s.key for s in snaps)

        peer = _Peer()

        class _Backend:
            inline_decide = True

            def snapshot_read(self, keys, now=None):
                return [(5, 60_000, 0, reset, True) for _ in keys]

        class _Inst:
            backend = _Backend()

            def get_peer(self, k):
                return peer

        m.instance = _Inst()
        m._tracked[key] = (0, 5, 60_000)
        m._moved[key] = (0, 5, 60_000)
        await m.flush_once()  # send fails: nothing may retire
        assert key in m._moved and key in m._tracked
        peer.fail = False
        await m.flush_once()  # delivered: now it retires
        assert peer.sent == [key]
        assert key not in m._moved and key not in m._tracked

    asyncio.run(run())


def test_flap_returned_key_stays_tracked():
    """A moved key the ring gives BACK to this node mid-window leaves
    the moved set but remains tracked — it is a live owned window
    again and must ride the NEXT ring change."""

    async def run():
        m = _mgr(rescale_double_serve=0.0)

        class _Self:
            host = ADDR
            is_owner = True

        class _Inst:
            def get_peer(self, k):
                return _Self()

        m.instance = _Inst()
        m._tracked["back"] = (0, 5, 60_000)
        m._moved["back"] = (0, 5, 60_000)
        await m.flush_once()
        assert "back" not in m._moved
        assert "back" in m._tracked

    asyncio.run(run())


def test_drain_ships_pending_snapshots():
    """A draining node forwards its PARKED pending snapshots (windows
    handed to it whose first owned touch never came) to the
    ring-minus-self owners — they must not die with the process."""

    async def run():
        m = _mgr()
        other = PeerClient(BehaviorConfig(), "10.0.0.2:81")
        sent = []

        async def record(snaps, owner=""):
            sent.extend(s.key for s in snaps)

        other.replicate_buckets = record
        picker = ConsistentHashPicker()
        picker.add(PeerClient(BehaviorConfig(), ADDR, is_owner=True))
        picker.add(other)

        class _Inst:
            pass

        inst = _Inst()
        inst.picker = picker

        class _Backend:
            inline_decide = True

            def snapshot_read(self, keys, now=None):
                return [None for _ in keys]  # nothing tracked-live

        inst.backend = _Backend()
        m.instance = inst
        now = millisecond_now()
        m._pending["pk1"] = _snap("pk1", reset_time=now + 60_000,
                                  now=now)
        m._pending["expired"] = _snap("expired", reset_time=now - 1,
                                      now=now)
        await m.drain()
        assert sent == ["pk1"]  # live pending forwarded, expired not

    asyncio.run(run())


# -- differential identity: rescale ON == OFF on a static ring --------------


def _conf(backend="exact", **kw) -> ServerConfig:
    conf = ServerConfig(
        grpc_address=ADDR,
        advertise_address=ADDR,
        backend=backend,
        rescale=True,
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


def _jax_conf():
    from gubernator_tpu.serve.config import BehaviorConfig as JB
    from gubernator_tpu.serve.config import ServerConfig as JS

    return JS(
        grpc_address=ADDR, advertise_address=ADDR, backend="exact",
        rescale=True, replication_sync_wait=60.0,
        behaviors=JB(
            peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3,
            breaker_cooldown=0.2,
        ),
    )


async def _fuzz_pair(mk_backend, mk_jax_backend, clock, steps, seed):
    """ON and OFF twins on an identical STATIC 2-host ring, plus the JAX
    package's ON twin; only the GUBER_RESCALE knob (or the package)
    differs, and only self-owned keys are driven: the static-ring identity
    contract. The manager's flush loop runs (manually ticked) and must act
    on nothing."""
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.serve.instance import Instance as JInstance
    from tests._util import free_ports

    def owned(dead_addr, count=200):
        picker = ConsistentHashPicker()
        mecl = PeerClient(BehaviorConfig(), ADDR, is_owner=True)
        picker.add(mecl)
        picker.add(PeerClient(BehaviorConfig(), dead_addr))
        return [
            f"f{i}" for i in range(count)
            # the shared _fuzz_stream issues name="replfuzz" requests;
            # the ownership screen must hash the same keys
            if picker.get(
                RateLimitReq(
                    name="replfuzz", unique_key=f"f{i}"
                ).hash_key()
            ) is mecl
        ]

    for port in free_ports(16):
        dead = f"127.0.0.1:{port}"
        keys = owned(dead)[:12]
        if len(keys) >= 8:
            break
    assert len(keys) >= 8, "no workable ring split in 16 rolls"

    async def mk(rescale):
        conf = _conf(rescale=rescale)
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
    try:
        rng = np.random.default_rng(seed)
        for step, batch, dt in _fuzz_stream(rng, keys, steps):
            clock.t += dt
            a = await on.get_rate_limits(batch)
            b = await off.get_rate_limits(batch)
            c = await twin.get_rate_limits([_jax_req(r) for r in batch])
            for x, y, z, r in zip(a, b, c, batch):
                _assert_same(x, y, (step, r))
                _assert_same(x, z, (step, r, "jax"))
            if step % 25 == 24:
                await on.rescale.flush_once()  # static ring: a no-op
                await twin.rescale.flush_once()
        assert on.rescale.tracked_len > 0, "fuzz never tracked a window"
        assert on.rescale.pending_len == 0
        assert list(on.rescale._tracked.items()) == list(twin.rescale._tracked.items())
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


# -- add-node / remove-node handoff cycle over real gRPC --------------------


def test_add_remove_node_handoff_never_under_admits():
    """The tentpole end-to-end, in-process and replication-OFF (the
    subsystem stands alone): drive a key over-limit on its owner, ADD a
    node the ring elects as its new owner, hand off, and the key stays
    over-limit on the new owner with the SAME window; then REMOVE the
    node and the key is still over-limit back on the original ring —
    never a fresh (under-admitting) window anywhere in the cycle."""
    from tests._util import free_ports
    from gubernator_tpu_torch.serve.server import PeersV1Servicer

    async def serve(inst, addr):
        server = grpc.aio.server()
        add_peers_servicer(server, PeersV1Servicer(inst))
        assert server.add_insecure_port(addr) != 0
        await server.start()
        return server

    def roll_addresses():
        """Ports + a key that A owns on the 2-ring and C owns on the
        3-ring; crc32 placement makes some port draws keyless, so
        re-roll instead of StopIterating."""
        for _ in range(16):
            pa, pb, pc = free_ports(3)
            addrs = [f"127.0.0.1:{p}" for p in (pa, pb, pc)]
            ring2 = _picker(addrs[:2], me=addrs[0])
            ring3 = _picker(addrs, me=addrs[0])
            for i in range(512):
                kh = _req(f"hk{i}").hash_key()
                if (
                    ring2.get(kh).is_owner
                    and ring3.get(kh).host == addrs[2]
                ):
                    return addrs, f"hk{i}"
        raise AssertionError("no A->C moving key in 16 port rolls")

    async def run():
        (addr_a, addr_b, addr_c), key = roll_addresses()

        def conf_for(me):
            c = _conf()
            c.grpc_address = me
            c.advertise_address = me
            return c

        async def boot(me, members):
            inst = Instance(conf_for(me), ExactBackend(1000))
            inst.start()
            await inst.set_peers([
                PeerInfo(address=h, is_owner=(h == me))
                for h in members
            ])
            return inst, await serve(inst, me)

        two = [addr_a, addr_b]
        three = [addr_a, addr_b, addr_c]
        a, srv_a = await boot(addr_a, two)
        b, srv_b = await boot(addr_b, two)
        c = srv_c = None
        try:
            r = (await a.get_rate_limits([_req(key, hits=9, limit=5)]))[0]
            assert r.error == "" and r.status == Status.OVER_LIMIT
            reset_time = r.reset_time
            assert _req(key).hash_key() in a.rescale._tracked

            # scale OUT: C joins; every node learns the new membership
            # (C first, so the handoff install lands owned)
            c, srv_c = await boot(addr_c, three)
            for node, me in ((a, addr_a), (b, addr_b)):
                await node.set_peers([
                    PeerInfo(address=h, is_owner=(h == me))
                    for h in three
                ])
            moved_before = _counter(metrics.RESCALE_KEYS_MOVED)
            await a.rescale.flush_once()
            assert _counter(metrics.RESCALE_KEYS_MOVED) > moved_before

            # the NEW owner answers the SAME frozen window: over-limit,
            # zero remaining, the original reset_time — no amnesia
            r = (await c.get_rate_limits([_req(key, hits=0, limit=5)]))[0]
            assert r.error == ""
            assert r.status == Status.OVER_LIMIT, (
                "quota amnesia on scale-out: the new owner opened a "
                "fresh window"
            )
            # created-over windows keep remaining == limit (the
            # reference's sticky-over semantics); the frozen refusal
            # and its ORIGINAL reset survive the move
            assert r.remaining == 5 and r.reset_time == reset_time
            # and through a forwarding peer (normal routing, post-flip)
            a.rescale._transition = None  # close the double-serve window
            r = (await a.get_rate_limits([_req(key, hits=0, limit=5)]))[0]
            assert r.error == "" and r.status == Status.OVER_LIMIT

            # scale IN: C leaves; C's own ring change ships its owned
            # windows back to the 2-ring owners before it goes
            for node, me in ((a, addr_a), (b, addr_b), (c, addr_c)):
                await node.set_peers([
                    PeerInfo(address=h, is_owner=(h == me))
                    for h in two
                ])
            await c.rescale.flush_once()
            r = (await a.get_rate_limits([_req(key, hits=0, limit=5)]))[0]
            assert r.error == ""
            assert r.status == Status.OVER_LIMIT, (
                "quota amnesia on scale-in: the returning owner opened "
                "a fresh window"
            )
            assert r.remaining == 5 and r.reset_time == reset_time
        finally:
            await srv_a.stop(None)
            await srv_b.stop(None)
            if srv_c is not None:
                await srv_c.stop(None)
            await a.stop()
            await b.stop()
            if c is not None:
                await c.stop()

    asyncio.run(run())


# -- satellites: replication under a ring flip ------------------------------


def test_replication_flush_resolves_successor_post_flip():
    """Ring-flip-mid-flush (r17 satellite): a membership change landing
    while the snapshot gather is in flight must re-resolve successors
    against the POST-change ring — the pre-change successor receives
    nothing."""
    from gubernator_tpu_torch.serve.replication import ReplicationManager

    async def run():
        conf = _conf()
        conf.replication = True
        inst = Instance(conf, ExactBackend(1000))
        inst.start()
        hosts = [ADDR, "10.0.0.2:81", "10.0.0.3:81"]
        await inst.set_peers([
            PeerInfo(address=h, is_owner=(h == ADDR)) for h in hosts
        ])
        repl = inst.repl
        sent = {}

        async def record(self, snaps, owner=""):
            sent.setdefault(self.host, []).extend(s.key for s in snaps)

        for p in inst.picker.peers():
            p.replicate_buckets = record.__get__(p)
        try:
            # a self-owned key whose successor DIFFERS between the
            # 3-ring and the 2-ring without its current successor
            key = None
            for i in range(512):
                k = _req(f"ff{i}").hash_key()
                if not inst.get_peer(k).is_owner:
                    continue
                succ3 = inst.picker.get_successor(k).host
                ring2 = _picker(
                    [h for h in hosts if h != succ3], me=ADDR
                )
                if ring2.get_successor(k).host != succ3:
                    key, old_succ = k, succ3
                    new_succ = ring2.get_successor(k).host
                    survivors = [h for h in hosts if h != succ3]
                    break
            assert key is not None, "no successor-flipping key found"

            await inst.get_rate_limits(
                [_req(f"ff{i}") for i in range(512)
                 if _req(f"ff{i}").hash_key() == key]
            )
            assert key in repl._dirty

            # the flip lands while the flush's snapshot gather is in
            # flight (the await point a device read would park on)
            orig = repl._snapshot

            async def snapshot_then_flip(metas):
                snaps = await orig(metas)
                await inst.set_peers([
                    PeerInfo(address=h, is_owner=(h == ADDR))
                    for h in survivors
                ])
                # re-stub the rebuilt ring's clients
                for p in inst.picker.peers():
                    p.replicate_buckets = record.__get__(p)
                return snaps

            repl._snapshot = snapshot_then_flip
            await repl.flush_once()
            assert key in sent.get(new_succ, []), (
                f"snapshot not shipped to the post-flip successor "
                f"({sent})"
            )
            assert key not in sent.get(old_succ, []), (
                "snapshot shipped to the PRE-flip successor"
            )
        finally:
            await inst.stop()

    asyncio.run(run())


def test_standby_purged_when_no_longer_successor():
    """Post-reshuffle standby hygiene (r17 satellite): rows for keys
    this node neither owns nor succeeds on the new ring are dropped
    (they could otherwise seed a WRONG takeover window later); rows it
    still succeeds — or now owns — survive."""
    async def run():
        conf = _conf()
        conf.replication = True
        inst = Instance(conf, ExactBackend(1000))
        inst.start()
        hosts = [ADDR, "10.0.0.2:81", "10.0.0.3:81", "10.0.0.4:81"]
        await inst.set_peers([
            PeerInfo(address=h, is_owner=(h == ADDR)) for h in hosts
        ])
        try:
            repl = inst.repl
            now = millisecond_now()
            # park standby rows for keys of EVERY succession class
            keys = [f"sp{i}" for i in range(256)]
            for k in keys:
                repl._standby[k] = _snap(k, reset_time=now + 60_000,
                                         now=now)
            # reshuffle: one non-self host leaves
            survivors = hosts[:2] + hosts[3:]
            await inst.set_peers([
                PeerInfo(address=h, is_owner=(h == ADDR))
                for h in survivors
            ])
            # set_peers already purged (the Instance hook); verify the
            # invariant the purge pins
            for k in list(repl._standby):
                own = inst.get_peer(k).is_owner
                succ = inst.picker.get_successor(k)
                assert own or (succ is not None and succ.is_owner), (
                    f"stale standby row survived for '{k}'"
                )
            purged = set(keys) - set(repl._standby)
            assert purged, "reshuffle purged nothing — fixture broken"
            for k in purged:
                own = inst.get_peer(k).is_owner
                succ = inst.picker.get_successor(k)
                assert not (
                    own or (succ is not None and succ.is_owner)
                ), f"purge dropped a row this node still covers ('{k}')"
        finally:
            await inst.stop()

    asyncio.run(run())


# -- GUBER_SHARDS re-partition identity -------------------------------------


def _drive_windows(be, n=64, now=T0):
    """Mixed live token windows: under, exhausted, created-over
    (sticky), plus a leaky entry (since r19 it migrates too, flags
    lane and all; snapshot_read still excludes it by scope)."""
    reqs = []
    for i in range(n):
        kind = i % 4
        reqs.append(RateLimitReq(
            name="rp", unique_key=f"rp{i}",
            hits=(2, 5, 9, 1)[kind],
            limit=(10, 5, 5, 10)[kind],
            duration=60_000,
            algorithm=(
                Algorithm.LEAKY_BUCKET if kind == 3
                else Algorithm.TOKEN_BUCKET
            ),
        ))
    be.engine.get_rate_limits(reqs, now=now)
    return [r.hash_key() for r in reqs]


def _rows_mod_duration(rows):
    """snapshot_read rows with the duration column dropped. Kept for
    the GLOBAL-replica install comparisons (upsert_globals without the
    r19 full lanes does not persist duration); the re-partition path
    now round-trips duration too, so those tests compare full rows."""
    return [
        None if r is None else (r[0], r[2], r[3], r[4]) for r in rows
    ]


def _twin_backends(monkeypatch, rows=4, slots=256):
    """The port's TorchBackend(device="cpu") and the JAX TpuBackend on one
    slot hash, same geometry and ladder."""
    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import TpuBackend as JTpuBackend

    pin_hash(monkeypatch, "blake2b")
    return (
        TorchBackend(StoreConfig(rows=rows, slots=slots), buckets=(64,), device="cpu"),
        JTpuBackend(JStoreConfig(rows=rows, slots=slots), buckets=(64,)),
    )


def _mixed_arrays(rng, n, keys):
    """One seeded decide batch over all four algorithms, peeks, oversized
    hits (sticky creates) and a few durations."""
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    idx = rng.integers(0, len(keys), n)
    return dict(
        key_hash=slot_hash_batch([keys[i] for i in idx]),
        hits=rng.choice([0, 1, 2, 9], n).astype(np.int64),
        limit=rng.choice([1, 5, 10], n).astype(np.int64),
        duration=rng.choice([1000, 60_000, 600_000], n).astype(np.int64),
        algo=(idx % 4).astype(np.int32),
        gnp=np.zeros(n, bool),
    )


def _assert_exports_equal(a, b):
    assert sorted(a) == sorted(b)
    for col in a:
        assert a[col].dtype == b[col].dtype, col
        np.testing.assert_array_equal(a[col], b[col], err_msg=col)


@pytest.mark.parametrize("seed", [1, 6])
def test_export_windows_matches_the_jax_engine(monkeypatch, seed):
    """The same decides on both engines, then export_windows at several
    instants (windows expiring between them): every column identical,
    dtype and store order included."""
    t, j = _twin_backends(monkeypatch)
    _assert_exports_equal(t.engine.export_windows(now=T0), j.engine.export_windows(now=T0))
    rng = np.random.default_rng(seed)
    keys = [f"ex{i}" for i in range(400)]
    now = T0
    for _ in range(10):
        now += int(rng.choice([1, 200, 5000]))
        f = _mixed_arrays(rng, 64, keys)
        t.engine.decide_arrays(now=now, **f)
        j.engine.decide_arrays(now=now, **f)
    for dt in (0, 900, 70_000, 700_000):
        a = t.engine.export_windows(now=now + dt)
        _assert_exports_equal(a, j.engine.export_windows(now=now + dt))
    assert t.engine.last_export["windows"] == a["key_hash"].shape[0]
    w = t.engine.export_windows(now=now)
    assert w["key_hash"].shape[0] > 100
    assert set(np.unique(w["flags"] & 14).tolist()) == {0, 2, 4, 8}
    assert w["is_over"].any()
    assert t.engine.last_export["bytes"] == w["key_hash"].shape[0] * 8 * 4


def test_repartition_flat_preserves_every_window(monkeypatch):
    """Flat to flat: the new engine holds every live window (the full-lane
    install), its store bytes equal the JAX engine's flat repartition,
    and decisions continue identically on both."""
    from gubernator_tpu.parallel.policy import ShardingPolicy
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    t, j = _twin_backends(monkeypatch)
    keys = _drive_windows(t)
    _drive_windows(j)
    moved = t.engine.repartition(now=T0 + 5)
    jmoved = j.engine.repartition(ShardingPolicy.single(), now=T0 + 5)
    assert moved is not t.engine and moved.device == t.engine.device
    assert t.snapshot_read(keys, now=T0 + 5) == moved.snapshot_read(
        slot_hash_batch(keys), now=T0 + 5
    )
    np.testing.assert_array_equal(moved.store.data.numpy(), np.asarray(jmoved.store.data))
    _assert_exports_equal(
        moved.export_windows(now=T0 + 5), t.engine.export_windows(now=T0 + 5)
    )
    rng = np.random.default_rng(2)
    f = _mixed_arrays(rng, 64, [f"rp{i}" for i in range(64)])
    ra = moved.decide_arrays(now=T0 + 10, **f)
    rb = jmoved.decide_arrays(now=T0 + 10, **f)
    rc = t.engine.decide_arrays(now=T0 + 10, **f)
    for x, y, z in zip(ra, rb, rc):
        np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
        np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(z, np.int64))


def test_repartition_refuses_more_than_one_shard(monkeypatch):
    """Once refused, now served: a flat engine repartitions onto 2 shards
    with every live window preserved, its store bytes equal to the JAX
    engine's repartition onto 2 devices."""
    import jax

    from gubernator_tpu.parallel.policy import ShardingPolicy as JShardingPolicy
    from gubernator_tpu_torch.core.hashing import slot_hash_batch
    from gubernator_tpu_torch.parallel.policy import ShardingPolicy
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    t, j = _twin_backends(monkeypatch)
    keys = _drive_windows(t)
    _drive_windows(j)
    two = t.engine.repartition(ShardingPolicy.over_mesh(["cpu"] * 2), now=T0 + 5)
    jtwo = j.engine.repartition(JShardingPolicy.over_mesh(jax.devices()[:2]), now=T0 + 5)
    assert isinstance(two, MeshEngine) and two.n == 2
    want = t.snapshot_read(keys, now=T0 + 5)
    assert two.snapshot_read(slot_hash_batch(keys), now=T0 + 5) == want
    assert len([r for r in want if r is not None]) == 48  # leaky out of scope
    np.testing.assert_array_equal(two.store_numpy(), np.asarray(jtwo.store.data))
    _assert_exports_equal(
        _sorted_export(two.export_windows(now=T0 + 5)),
        _sorted_export(t.engine.export_windows(now=T0 + 5)),
    )


def _sorted_export(w: dict) -> dict:
    """An export's columns in key order (a mesh exports in shard order)."""
    o = np.argsort(w["key_hash"], kind="stable")
    return {k: v[o] for k, v in w.items()}


def _mesh_twins(monkeypatch, n=8, rows=4, slots=256):
    """The port's MeshBackend on n CPU shards and the JAX MeshBackend on n
    simulated devices, one slot hash, same geometry and ladder."""
    import jax

    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import MeshBackend as JMeshBackend
    from gubernator_tpu_torch.serve.backends import MeshBackend

    pin_hash(monkeypatch, "blake2b")
    return (
        MeshBackend(StoreConfig(rows=rows, slots=slots), devices=["cpu"] * n, buckets=(64,)),
        JMeshBackend(JStoreConfig(rows=rows, slots=slots), devices=jax.devices()[:n],
                     buckets=(64,)),
    )


def test_repartition_flat_to_mesh_preserves_every_window(monkeypatch):
    """Flat to an 8-shard mesh: every live window (full rows, duration
    included) answers the same snapshot, the store bytes equal the JAX
    engine's repartition onto 8 devices, and decisions continue
    identically on the flat engine, the mesh and the JAX mesh."""
    import jax

    from gubernator_tpu.parallel.policy import ShardingPolicy as JShardingPolicy
    from gubernator_tpu_torch.core.hashing import slot_hash_batch
    from gubernator_tpu_torch.parallel.policy import ShardingPolicy

    t, j = _twin_backends(monkeypatch)
    keys = _drive_windows(t)
    _drive_windows(j)
    mesh = t.engine.repartition(ShardingPolicy.over_mesh(["cpu"] * 8), now=T0 + 5)
    jmesh = j.engine.repartition(JShardingPolicy.over_mesh(jax.devices()), now=T0 + 5)
    kh = slot_hash_batch(keys)
    a = t.snapshot_read(keys, now=T0 + 5)
    assert a == mesh.snapshot_read(kh, now=T0 + 5) == jmesh.snapshot_read(kh, now=T0 + 5)
    assert len([r for r in a if r is not None]) == 48
    np.testing.assert_array_equal(mesh.store_numpy(), np.asarray(jmesh.store.data))
    token = [i for i in range(len(keys)) if i % 4 != 3]
    n = len(token)
    args = (kh[token], np.ones(n, np.int64), np.full(n, 5, np.int64),
            np.full(n, 60_000, np.int64), np.zeros(n, np.int32), np.zeros(n, bool), T0 + 10)
    ra = t.engine.decide_arrays(*args)
    for other in (mesh.decide_arrays(*args), jmesh.decide_arrays(*args)):
        for x, y in zip(ra, other):
            np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))


def test_mesh_backend_repartition_shard_count_change(monkeypatch):
    """MeshBackend.repartition: 8 shards -> 2 -> flat, every live window
    preserved at each step and each store equal to the JAX backend's after
    the same steps; sticky and exhausted windows still peek OVER."""
    import jax

    be, jbe = _mesh_twins(monkeypatch)
    keys = _drive_windows(be)
    _drive_windows(jbe)
    want = be.snapshot_read(keys, now=T0 + 5)
    assert want == jbe.snapshot_read(keys, now=T0 + 5)
    assert be.engine.n == 8
    be.repartition(devices=["cpu"] * 2, now=T0 + 5)
    jbe.repartition(devices=jax.devices()[:2], now=T0 + 5)
    assert be.engine.n == 2
    assert be.snapshot_read(keys, now=T0 + 5) == want
    np.testing.assert_array_equal(be.engine.store_numpy(), np.asarray(jbe.engine.store.data))
    be.repartition(devices=["cpu"], now=T0 + 5)
    jbe.repartition(devices=jax.devices()[:1], now=T0 + 5)
    assert be.engine.policy.flat and jbe.engine.flat
    assert be.snapshot_read(keys, now=T0 + 5) == want
    np.testing.assert_array_equal(be.engine.store_numpy(), np.asarray(jbe.engine.store.data))
    peek = [RateLimitReq(name="rp", unique_key=f"rp{i}", hits=0, limit=5, duration=60_000)
            for i in range(64) if i % 4 in (1, 2)]
    for r, x in zip(peek, be.decide(peek, [False] * len(peek), now=T0 + 6)):
        assert x.status == Status.OVER_LIMIT
        assert x.remaining == (5 if int(r.unique_key[2:]) % 4 == 2 else 0)


def test_differential_identity_fuzz_mesh(monkeypatch):
    """The ON == OFF identity through the 8-shard mesh (instance ->
    batcher -> arrival prep -> merged submit -> the per-shard decides),
    and the port's ON Instance answering as the JAX package's on 8
    simulated devices: the tracked set is host state only and the
    snapshot reads are non-mutating on the sharded store too."""
    import jax

    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import MeshBackend as JMeshBackend
    from gubernator_tpu_torch.serve.backends import MeshBackend

    clock = FakeClock()
    _pin_clock(monkeypatch, clock)
    pin_hash(monkeypatch, "blake2b")

    def be():
        return MeshBackend(StoreConfig(rows=4, slots=256), devices=["cpu"] * 8,
                           buckets=(16, 64))

    def jbe():
        return JMeshBackend(JStoreConfig(rows=4, slots=256), devices=jax.devices(),
                            buckets=(16, 64))

    asyncio.run(_fuzz_pair(be, jbe, clock, 60, 7))


def test_export_windows_empty_and_scope():
    from gubernator_tpu_torch.core.store import FLAG_ALGO_LEAKY

    flat = TorchBackend(StoreConfig(rows=4, slots=256), buckets=(64,), device="cpu")
    w = flat.engine.export_windows(now=T0)
    assert w["key_hash"].shape[0] == 0  # nothing ever decided
    _drive_windows(flat, n=8)
    w = flat.engine.export_windows(now=T0 + 5)
    # r19 widened the export to flag-aware rows: the 2 leaky entries
    # ride along now, carrying their algo bit in the flags lane
    assert w["key_hash"].shape[0] == 8
    assert int(
        ((w["flags"] & FLAG_ALGO_LEAKY) != 0).sum()
    ) == 2
    assert (w["duration"] == 60_000).all()
    # expired windows drop out of the export
    w = flat.engine.export_windows(now=T0 + 120_000)
    assert w["key_hash"].shape[0] == 0
