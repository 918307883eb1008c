"""The port's serving core against the JAX package's, on the CPU.

The port's `Instance(TorchBackend(device="cpu"))` and the JAX
`Instance(TpuBackend)` take the same caller groups, one `await` at a time,
under one pinned clock (the fake clock of tests/test_partitioned.py), with
the sketch tier on over a tiny store (`StoreConfig(rows=1, slots=16)` plus
a 2 x 4096 int32 sketch) so tier pressure starts at once:

- all four algorithms, duplicate keys, hits-0 peeks and GLOBAL items on a
  one-node ring, through both `get_rate_limits` and `batcher.decide_arrays`,
  with arrival prep on and off;
- identical responses after every group; identical store bytes, sketch
  bytes, EngineStats, shed-cache stats and entries, and promoter stats at
  the end, after one promoter tick on each side;
- GLOBAL replica installs (`update_peer_globals`) and the self-destined
  hit flush (`apply_global_hits_local`) on both stacks;
- each on both slot hashes, blake2b-8 and the port's native XXH64, both
  packages pinned to the same one (tests/test_torch_hash.py).

Inputs come from numpy seeds; tolerance is zero (integer math). Batch
composition is kept deterministic: groups go one at a time, the GLOBAL
broadcast runs by an explicit drain on both sides (its loop's window is
longer than the test), the promoter's loop never ticks by itself, and its
observer samples every dispatch on both sides.
"""

import asyncio
import subprocess
import sys

import numpy as np
import pytest
import torch

import gubernator_tpu.api.types as j_types
import gubernator_tpu.core.engine as j_engine
import gubernator_tpu.serve.promoter as j_promoter
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.serve.promoter as t_promoter
from test_torch_hash import HASHES, pin_hash
from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.serve.backends import TpuBackend
from gubernator_tpu.serve.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu.serve.config import ServerConfig as JServerConfig
from gubernator_tpu.serve.instance import Instance as JInstance
from gubernator_tpu_torch.core.sketches import SketchConfig
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import TorchBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7975"
LADDER = (64,)
N_KEYS = 48


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self) -> int:
        return self.t


@pytest.fixture(params=HASHES)
def clock(monkeypatch, request):
    """One pinned clock for both packages; both packages on one slot
    hash, blake2b-8 or the port's native XXH64 (tests/test_torch_hash.py);
    the promoter's observer sampling every dispatch on both."""
    c = FakeClock()
    monkeypatch.setattr(j_types, "millisecond_now", c)
    monkeypatch.setattr(j_engine, "millisecond_now", c, raising=False)
    monkeypatch.setattr(t_types, "millisecond_now", c)
    pin_hash(monkeypatch, request.param)
    monkeypatch.setattr(j_promoter, "OBSERVE_MIN_INTERVAL_S", 0.0)
    monkeypatch.setattr(t_promoter, "OBSERVE_MIN_INTERVAL_S", 0.0)
    return c


def _conf(cls, bcls, prep: bool):
    return cls(
        grpc_address=ADDR,
        advertise_address=ADDR,
        behaviors=bcls(global_sync_wait=600.0),
        device_batch_limit=LADDER[-1],
        prep_at_arrival=prep,
        sketch_sync_wait=600.0,
    )


async def _stacks(clock, prep: bool):
    t = Instance(
        _conf(ServerConfig, BehaviorConfig, prep),
        TorchBackend(
            StoreConfig(rows=1, slots=16), buckets=LADDER,
            sketch=SketchConfig(2, 1 << 12, 4), device="cpu",
        ),
    )
    j = JInstance(
        _conf(JServerConfig, JBehaviorConfig, prep),
        TpuBackend(
            JStoreConfig(rows=1, slots=16), buckets=LADDER,
            sketch=JSketchConfig(2, 1 << 12, 4),
        ),
    )
    for inst, info in ((t, t_types.PeerInfo), (j, j_types.PeerInfo)):
        inst.start()
        await inst.set_peers([info(address=ADDR, is_owner=True)])
        inst.shed.now_fn = clock
    return t, j


def _resp_tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))


def _key_params(rng):
    """Per-key (algorithm, limit, duration), fixed per key so frozen token
    refusals can shed: even keys (the hottest among them) token, odd keys
    one of the other three."""
    return [
        (0 if k % 2 == 0 else int(rng.integers(1, 4)),
         int(rng.choice([1, 2, 3, 50])),
         int(rng.choice([400, 2000, 60_000, 60_000])))
        for k in range(N_KEYS)
    ]


def _reqs(types, rng, params, n):
    out = []
    for _ in range(n):
        k = int(min(rng.zipf(1.3) - 1, N_KEYS - 1))
        algo, limit, duration = params[k]
        if rng.random() < 0.05:
            limit += 1  # a param drift: the stored window's params answer
        out.append(types.RateLimitReq(
            name="svc", unique_key=f"k{k}",
            hits=int(rng.choice([0, 1, 1, 1, 2, 7])),
            limit=limit, duration=duration,
            algorithm=types.Algorithm(algo),
            behavior=types.Behavior(int(rng.choice([0, 0, 0, 1, 2]))),
        ))
    return out


def _fields(rng, params, n, hashes):
    ks = np.minimum(rng.zipf(1.3, n) - 1, N_KEYS - 1)
    p = np.array([params[k] for k in ks], np.int64).reshape(n, 3)
    return dict(
        key_hash=hashes[ks],
        hits=rng.choice([0, 1, 1, 2], n).astype(np.int64),
        limit=p[:, 1],
        duration=p[:, 2],
        algo=p[:, 0].astype(np.int32),
    )


def _assert_state_same(t, j, msg):
    te, je = t.backend.engine, j.backend.engine
    np.testing.assert_array_equal(
        te.store.data.numpy(), np.asarray(je.store.data), err_msg=f"store {msg}"
    )
    np.testing.assert_array_equal(
        te.sketch.data.numpy(), np.asarray(je.sketch.data), err_msg=f"sketch {msg}"
    )
    t_stats = t.backend.stats()
    # the port counts the distinct keys of its batches too, and the
    # store's occupied entries (tag lane set)
    assert t_stats.pop("groups") >= t_stats["batches"], msg
    assert t_stats.pop("size") == np.count_nonzero(np.asarray(je.store.data)[:, ::8]), msg
    assert t_stats == j.backend.stats(), msg
    assert t.shed.stats() == j.shed.stats(), msg
    assert dict(t.shed._entries) == dict(j.shed._entries), msg
    assert te.reset_generation == je.reset_generation, msg


@pytest.mark.parametrize("prep", [True, False], ids=["arrival_prep", "flush_prep"])
def test_instance_matches_jax_instance(clock, prep):
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    async def run():
        t, j = await _stacks(clock, prep)
        try:
            rng = np.random.default_rng(31 if prep else 32)
            params = _key_params(rng)
            hashes = slot_hash_batch([f"svc_k{k}" for k in range(N_KEYS)])
            for step in range(36):
                clock.t += int(rng.choice([0, 0, 1, 9, 200, 2500, 61_000]))
                n = int(rng.integers(1, 33))
                if step % 4 == 3:
                    f = _fields(rng, params, n, hashes)
                    a = await t.batcher.decide_arrays(dict(f))
                    b = await j.batcher.decide_arrays(dict(f))
                    for x, y, name in zip(a, b, ("status", "limit", "remaining", "reset")):
                        np.testing.assert_array_equal(
                            np.asarray(x, np.int64), np.asarray(y, np.int64),
                            err_msg=f"step {step} {name}",
                        )
                else:
                    state = rng.bit_generator.state
                    tr = _reqs(t_types, rng, params, n)
                    rng.bit_generator.state = state
                    jr = _reqs(j_types, rng, params, n)
                    a = await t.get_rate_limits(tr)
                    b = await j.get_rate_limits(jr)
                    assert [_resp_tuple(x) for x in a] == [_resp_tuple(y) for y in b], (
                        step, tr,
                    )
                await t.global_mgr.drain()
                await j.global_mgr.drain()
            _assert_state_same(t, j, "after the stream")
            stats = t.backend.stats()
            assert stats["dropped"] > 0, stats  # tier pressure engaged
            assert t.shed.hits > 0, t.shed.stats()  # shed-cache hits happened
            await t.promoter.flush_once()
            await j.promoter.flush_once()
            assert t.promoter.stats() == j.promoter.stats()
            assert t.promoter.stats()["promotions"] > 0
            _assert_state_same(t, j, "after one promoter tick")
        finally:
            await t.stop()
            await j.stop()

    asyncio.run(run())


def test_global_installs_and_self_flush_match_jax(clock):
    """update_peer_globals (replica installs, with the shed purge) and
    apply_global_hits_local (the self-destined GLOBAL hit flush) leave
    the same state on both stacks and answer the same afterwards."""

    async def run():
        t, j = await _stacks(clock, True)
        try:
            rng = np.random.default_rng(41)
            keys = [f"g{i}" for i in range(20)]
            for types_mod, inst in ((t_types, t), (j_types, j)):
                upd = [
                    (f"svc_{k}", types_mod.RateLimitResp(
                        status=types_mod.Status(int(i % 3 == 0)), limit=10,
                        remaining=int(i % 3 != 0) * (10 - i % 10),
                        reset_time=T0 + 60_000 + i,
                    ))
                    for i, k in enumerate(keys)
                ]
                await inst.update_peer_globals(upd)
            _assert_state_same(t, j, "after update_peer_globals")
            clock.t += 5
            hits = rng.integers(0, 5, len(keys))
            for types_mod, inst in ((t_types, t), (j_types, j)):
                reqs = [
                    types_mod.RateLimitReq(
                        name="svc", unique_key=k, hits=int(h), limit=10,
                        duration=60_000, behavior=types_mod.Behavior.GLOBAL,
                    )
                    for k, h in zip(keys, hits)
                ]
                await inst.apply_global_hits_local(reqs)
                await inst.global_mgr.drain()
            _assert_state_same(t, j, "after apply_global_hits_local")
            clock.t += 5
            probe_t = [t_types.RateLimitReq(name="svc", unique_key=k, hits=1, limit=10,
                                            duration=60_000) for k in keys]
            probe_j = [j_types.RateLimitReq(name="svc", unique_key=k, hits=1, limit=10,
                                            duration=60_000) for k in keys]
            a = await t.get_rate_limits(probe_t)
            b = await j.get_rate_limits(probe_j)
            assert [_resp_tuple(x) for x in a] == [_resp_tuple(y) for y in b]
            _assert_state_same(t, j, "after the probe")
        finally:
            await t.stop()
            await j.stop()

    asyncio.run(run())


def test_apply_global_hits_matches_jax_engine():
    """TorchEngine.apply_global_hits against the JAX flat engine's, with
    more keys than the ladder's top rung (chunked), duplicates and all
    four algorithms: same answers and store bytes; the stats and the
    observer are left untouched."""
    from gubernator_tpu.core.engine import TpuEngine
    from gubernator_tpu_torch.core.engine import TorchEngine

    te = TorchEngine(StoreConfig(rows=2, slots=16), buckets=(64,), device="cpu",
                     sketch=SketchConfig(2, 1 << 10, 4))
    je = TpuEngine(JStoreConfig(rows=2, slots=16), buckets=(64,),
                   sketch=JSketchConfig(2, 1 << 10, 4))
    seen = []
    te.observe_hook = seen.append
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 2**64, 90, dtype=np.uint64)
    now = T0
    for step in range(3):
        now += 700
        n = 150
        kh = pool[rng.integers(0, pool.shape[0], n)]
        cols = (rng.integers(0, 4, n).astype(np.int64), np.full(n, 9, np.int64),
                np.full(n, 2000, np.int64))
        algo = rng.integers(0, 4, n).astype(np.int32)
        a = te.apply_global_hits(kh, *cols, now, algo=algo)
        b = je.apply_global_hits(kh, *cols, now, algo=algo)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
        np.testing.assert_array_equal(te.store.data.numpy(), np.asarray(je.store.data))
        np.testing.assert_array_equal(te.sketch.data.numpy(), np.asarray(je.sketch.data))
    assert te.stats.snapshot()["batches"] == 0 and not seen
    assert te.observe_hook is not None


def test_apply_global_hits_keeps_a_concurrent_fetchs_stats():
    """A fetch of an earlier batch that lands while apply_global_hits runs
    (the batcher's fetch threads run beside the submit thread) counts in
    the engine's stats; the gossip chunks themselves do not."""
    from gubernator_tpu_torch.core.engine import TorchEngine

    te, twin = (TorchEngine(StoreConfig(rows=2, slots=16), buckets=(64,), device="cpu")
                for _ in range(2))
    rng = np.random.default_rng(12)
    kh = rng.integers(0, 2**64, 40, dtype=np.uint64)
    ones = np.ones(40, np.int64)
    batch = (kh, ones, ones * 5, ones * 60_000, np.zeros(40, np.int32), np.zeros(40, bool), T0)
    twin.decide_arrays(*batch)
    earlier = te.decide_submit(*batch)
    submit = te.decide_submit
    landed = []

    def submit_then_fetch(*a, **kw):
        # the earlier batch's fetch lands in the middle of the call
        if not landed:
            landed.append(te.decide_wait(earlier))
        return submit(*a, **kw)

    te.decide_submit = submit_then_fetch
    te.apply_global_hits(kh[:10], ones[:10], ones[:10] * 5, ones[:10] * 60_000, T0 + 1)
    assert landed
    assert te.stats.snapshot() == twin.stats.snapshot()
    assert te.stats.snapshot()["batches"] == 1


def test_managers_build_and_a_wider_ring_serves(clock):
    """Replication, rescale and checkpointing build their managers on the
    device backend (tests/test_torch_{replication,rescale,checkpoint}.py
    hold them against the JAX package); a ring with other members is
    served (the forwarding half came with the doors), and so is a chained
    item (tests/test_torch_chains.py holds chains against the JAX
    package)."""
    backend = TorchBackend(StoreConfig(rows=1, slots=16), buckets=LADDER, device="cpu")
    for kw, attr in ((dict(replication=True), "repl"), (dict(rescale=True), "rescale"),
                     (dict(checkpoint_dir="/nonexistent/ckpt"), "checkpoint")):
        built = Instance(ServerConfig(grpc_address=ADDR, **kw), backend)
        assert getattr(built, attr) is not None
        assert built.batcher.prep_at_arrival  # the device backend keeps its prep

    async def run():
        inst = Instance(ServerConfig(grpc_address=ADDR, sketch=False), backend)
        inst.start()
        try:
            await inst.set_peers([
                t_types.PeerInfo(address=ADDR, is_owner=True),
                t_types.PeerInfo(address="127.0.0.1:7976"),
            ])
            assert inst.health_check().peer_count == 2
            await inst.set_peers([t_types.PeerInfo(address=ADDR, is_owner=True)])
            assert inst.health_check().status == "healthy"
            assert inst.health_check().peer_count == 1
            r = t_types.RateLimitReq(
                name="c", unique_key="leaf", hits=1, limit=5, duration=1000,
                chain=[t_types.ChainLevel(unique_key="root", limit=9)],
            )
            resp = (await inst.get_rate_limits([r]))[0]
            assert resp.error == "" and resp.status == t_types.Status.UNDER_LIMIT
            assert (resp.limit, resp.remaining) == (5, 4)  # the leaf answers
        finally:
            await inst.stop()

    asyncio.run(run())


def test_decide_wait_waits_on_its_own_batch_event(monkeypatch):
    """On a CUDA tensor the submit starts a non-blocking copy into pinned
    host memory and records an event; decide_wait synchronizes THAT
    event, not the device. Simulated on the CPU by handing _handle a
    packed tensor that claims to live on cuda."""
    from gubernator_tpu_torch.core.engine import TorchEngine

    calls = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            calls.append("record")

        def synchronize(self):
            calls.append("event.synchronize")

    class FakePacked:
        device = torch.device("cuda")
        shape = (8,)
        dtype = torch.int32

    copies = []

    def fake_empty(shape, dtype, pin_memory):
        assert pin_memory
        host = torch.zeros(shape, dtype=dtype)

        def copy_(src, non_blocking):
            assert non_blocking
            copies.append(src)
            return host

        host.copy_ = copy_
        return host

    e = TorchEngine(StoreConfig(rows=1, slots=16), buckets=(64,), device="cpu")
    e.clock.epoch = T0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("device.synchronize"))
    monkeypatch.setattr(torch, "empty", fake_empty)
    packed = FakePacked()
    host, event, *_ = e._handle(packed, None, np.arange(1, dtype=np.int32), 1, 1)
    assert copies == [packed] and isinstance(event, FakeEvent)
    assert calls == ["record"]
    e.decide_wait((host, event, None, np.arange(1, dtype=np.int32), 1, 1, T0))
    assert calls == ["record", "event.synchronize"]


def test_serving_core_imports_no_grpc_aiohttp_or_protobuf():
    """The serving core loads and serves with grpc, aiohttp and protobuf
    blocked (sys.modules[name] = None makes any import of them fail)."""
    code = (
        "import sys\n"
        "for m in ('grpc', 'aiohttp', 'google.protobuf', 'google'):\n"
        "    sys.modules[m] = None\n"
        "import asyncio\n"
        "from gubernator_tpu_torch.api.types import PeerInfo, RateLimitReq\n"
        "from gubernator_tpu_torch.core.store import StoreConfig\n"
        "from gubernator_tpu_torch.core.sketches import SketchConfig\n"
        "from gubernator_tpu_torch.serve import (aio, backends, batcher, breaker,\n"
        "    config, faults, global_mgr, instance, metrics, peers, prep, promoter,\n"
        "    shedcache, stages, tracing)\n"
        "async def main():\n"
        "    conf = config.config_from_env({'GUBER_GRPC_ADDRESS': '127.0.0.1:9'})\n"
        "    b = backends.TorchBackend(StoreConfig(rows=1, slots=16), buckets=(64, 1024),\n"
        "                              sketch=SketchConfig(2, 1024, 4), device='cpu')\n"
        "    inst = instance.Instance(conf, b)\n"
        "    inst.start()\n"
        "    await inst.set_peers([PeerInfo(address='127.0.0.1:9', is_owner=True)])\n"
        "    r = await inst.get_rate_limits([RateLimitReq(name='a', unique_key='b',\n"
        "                                   hits=1, limit=2, duration=1000)])\n"
        "    assert r[0].remaining == 1, r\n"
        "    await inst.stop()\n"
        "asyncio.run(main())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'grpc',\n"
        "       'aiohttp', 'gubernator_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_arrival_prep_surfaces_match_jax():
    """prep_run (prep_run_single), merge_prepped (serve/prep.merge_runs +
    build_presorted_request), decide_submit_merged and
    decide_submit_presorted against the JAX flat engine: the same sorted
    runs, the same padded batch and groups, the same answers and store;
    and the merged path equals the flush-time presort of the
    concatenated groups."""
    from gubernator_tpu.core.engine import TpuEngine
    from gubernator_tpu.serve.prep import merge_runs as j_merge_runs
    from gubernator_tpu_torch.core.engine import TorchEngine, pad_request_sorted
    from gubernator_tpu_torch.serve.prep import merge_runs

    def mk():
        return (
            TorchEngine(StoreConfig(rows=2, slots=16), buckets=(64, 256), device="cpu",
                        sketch=SketchConfig(2, 1 << 10, 4)),
            TpuEngine(JStoreConfig(rows=2, slots=16), buckets=(64, 256),
                      sketch=JSketchConfig(2, 1 << 10, 4)),
        )

    te, je = mk()
    te2, je2 = mk()
    rng = np.random.default_rng(23)
    pool = rng.integers(0, 2**64, 120, dtype=np.uint64)
    pool[:10] >>= np.uint64(32)
    now = T0
    for step in range(5):
        now += int(rng.choice([1, 300, 5000]))
        groups = []
        for _ in range(int(rng.integers(1, 6))):
            n = int(rng.integers(1, 40))
            groups.append(dict(
                key_hash=pool[rng.integers(0, pool.shape[0], n)],
                hits=rng.choice([0, 1, 2, 1 << 40], n).astype(np.int64),
                limit=rng.choice([1, 5, -3, 1 << 33], n).astype(np.int64),
                duration=rng.choice([1000, 60_000, 1 << 31], n).astype(np.int64),
                algo=rng.integers(0, 4, n).astype(np.int32),
                gnp=rng.random(n) < 0.1,
            ))
        t_runs = [te.prep_run(g) for g in groups]
        j_runs = [je.prep_run(g) for g in groups]
        for a, b in zip(t_runs, j_runs):
            np.testing.assert_array_equal(a["skey"], b["skey"])
            np.testing.assert_array_equal(a["order"], b["order"])
            for k in a["fields"]:
                np.testing.assert_array_equal(a["fields"][k], b["fields"][k], err_msg=k)
        tm, jm = te.merge_prepped(t_runs), je.merge_prepped(j_runs)
        for name in ("req", "groups"):
            for x, y in zip(tm[name], jm[name]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        np.testing.assert_array_equal(tm["order"], jm["order"])
        # the merged batch equals the flush-time presort of the concat
        cat = {k: np.concatenate([g[k] for g in groups]) for k in groups[0]}
        req, order, grp = pad_request_sorted(
            te.buckets, te.config.slots, cat["key_hash"], cat["hits"], cat["limit"],
            cat["duration"], cat["algo"], cat["gnp"], with_groups=True)
        for x, y in zip(tm["req"], req):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(tm["groups"], grp):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(tm["order"], order)
        a = te.decide_wait(te.decide_submit_merged(tm, now))
        b = je.decide_wait(je.decide_submit_merged(jm, now))
        mt, mj = merge_runs(t_runs), j_merge_runs(j_runs)
        c = te2.decide_wait(te2.decide_submit_presorted(
            mt["fields"], mt["skey"], mt["order"], mt["counts"], now))
        d = je2.decide_wait(je2.decide_submit_presorted(
            mj["fields"], mj["skey"], mj["order"], mj["counts"], now))
        for x, y, z, w in zip(a, b, c, d):
            np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
            np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(z, np.int64))
            np.testing.assert_array_equal(np.asarray(z, np.int64), np.asarray(w, np.int64))
        np.testing.assert_array_equal(te.store.data.numpy(), np.asarray(je.store.data))
        np.testing.assert_array_equal(te2.store.data.numpy(), te.store.data.numpy())
        np.testing.assert_array_equal(te.sketch.data.numpy(), np.asarray(je.sketch.data))
    assert te.stats.snapshot() == je.stats.snapshot() == te2.stats.snapshot()
