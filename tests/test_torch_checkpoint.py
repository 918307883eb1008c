"""The port's checkpoint/restore (serve/checkpoint.py) on the CPU: the
cases of tests/test_checkpoint.py with the port in place of the JAX
package (its mesh cases on the port's MeshEngine, 8 or 4 CPU shards), the
JAX package as the twin in each differential.

The torn-write-safe file format, boot-time warm restore with its
staleness/corruption/version cold-boot gates, the shed purge on a restore
install, the blue-green import marker protocol with its LWW no-op
guarantee, the checkpoint fault points (a hung write never blocks serving;
a torn file restores cold, never crashes), the all-algorithm restore
property on TorchBackend(device="cpu"), and the ON == OFF identity with the
JAX package's ON twin writing byte-identical chunk, lane and manifest files
from the same traffic. Checkpoints restore across the two packages in both
directions, the answers after the restore identical to the writer's.
"""

import asyncio
import json
import os

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
from gubernator_tpu_torch.serve import checkpoint as ckpt_mod
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.backends import ExactBackend, TorchBackend
from gubernator_tpu_torch.serve.checkpoint import (
    CheckpointError,
    CheckpointManager,
    read_checkpoint,
    write_checkpoint,
)
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.faults import FAULTS
from gubernator_tpu_torch.serve.instance import Instance
from gubernator_tpu_torch.serve.replication import Snapshot

from test_torch_replication import (  # noqa: F401 (shared rig)
    FakeClock,
    _assert_same,
    _fuzz_stream,
    _jax_req,
    _pin_clock,
    _snap,
)

ADDR = "127.0.0.1:1"
T0 = 1_700_000_000_000


def _pin(monkeypatch, clock):
    import gubernator_tpu.serve.checkpoint as j_ckpt_mod

    _pin_clock(monkeypatch, clock)
    monkeypatch.setattr(ckpt_mod, "millisecond_now", clock)
    monkeypatch.setattr(j_ckpt_mod, "millisecond_now", clock)


def _req(key, hits=1, limit=5, duration=60_000,
         algo=Algorithm.TOKEN_BUCKET):
    return RateLimitReq(
        name="ckpt", unique_key=key, hits=hits, limit=limit,
        duration=duration, algorithm=algo,
    )


def _counter(metric, **labels) -> float:
    m = metric.labels(**labels) if labels else metric
    return m._value.get()


def _conf(**kw) -> ServerConfig:
    conf = ServerConfig(
        grpc_address=ADDR,
        advertise_address=ADDR,
        backend="exact",
        behaviors=BehaviorConfig(
            peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3,
            breaker_cooldown=0.2,
        ),
    )
    conf.checkpoint_interval = 60.0  # flushes driven manually
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


async def _instance(conf, backend=None) -> Instance:
    inst = Instance(
        conf, backend if backend is not None else ExactBackend(1000)
    )
    inst.start()
    await inst.set_peers([
        PeerInfo(address=conf.advertise_address, is_owner=True)
    ])
    return inst


# -- file format -------------------------------------------------------------


def _rows(n, now=None, **kw):
    now = millisecond_now() if now is None else now
    return [_snap(f"ck{i}", remaining=i, now=now, **kw) for i in range(n)]


def test_file_roundtrip_and_manifest(tmp_path):
    d = str(tmp_path)
    snaps = _rows(6000)  # > CHUNK_ROWS: multiple chunk files
    lanes = {c: list(range(7)) for c in ckpt_mod.LANE_COLS}
    write_checkpoint(d, snaps, lanes, "10.0.0.1:81", T0)
    manifest, got, got_lanes = read_checkpoint(d)
    assert manifest["format_version"] == ckpt_mod.FORMAT_VERSION
    assert manifest["advertise"] == "10.0.0.1:81"
    assert manifest["snapshot_ms"] == T0
    assert manifest["windows"] == 6000 and len(manifest["chunks"]) == 2
    assert got == snaps
    assert got_lanes == lanes
    # a SMALLER checkpoint over the same dir leaves no stale chunks
    write_checkpoint(d, snaps[:10], None, "10.0.0.1:81", T0 + 1)
    manifest2, got2, lanes2 = read_checkpoint(d)
    assert manifest2["windows"] == 10 and len(got2) == 10
    assert lanes2 is None
    files = sorted(os.listdir(d))
    assert files == ["chunk-0000.json", "manifest.json"]


def test_read_missing_manifest_is_cold_not_failure(tmp_path):
    assert read_checkpoint(str(tmp_path)) is None


def test_read_torn_chunk_raises_corrupt(tmp_path):
    d = str(tmp_path)
    write_checkpoint(d, _rows(100), None, "a:1", T0)
    p = os.path.join(d, "chunk-0000.json")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)  # torn write
    with pytest.raises(CheckpointError) as ei:
        read_checkpoint(d)
    assert ei.value.kind == "corrupt"


def test_read_missing_chunk_raises_read(tmp_path):
    d = str(tmp_path)
    write_checkpoint(d, _rows(3), None, "a:1", T0)
    os.remove(os.path.join(d, "chunk-0000.json"))
    with pytest.raises(CheckpointError) as ei:
        read_checkpoint(d)
    assert ei.value.kind == "read"


def test_read_future_format_version_refused(tmp_path):
    d = str(tmp_path)
    write_checkpoint(d, _rows(3), None, "a:1", T0)
    mp = os.path.join(d, "manifest.json")
    with open(mp) as f:
        m = json.load(f)
    m["format_version"] = ckpt_mod.FORMAT_VERSION + 1
    with open(mp, "w") as f:
        json.dump(m, f)
    with pytest.raises(CheckpointError) as ei:
        read_checkpoint(d)
    assert ei.value.kind == "version"


# -- boot-time restore -------------------------------------------------------


def test_restore_roundtrip_over_limit_survives_restart(tmp_path):
    """The headline contract: an over-limit window checkpointed by one
    process is still over-limit after a cold start of a NEW process
    pointed at the same directory — no quota amnesia."""

    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            r = (await a.get_rate_limits([_req("hot", hits=9, limit=5)]))[0]
            assert r.status == Status.OVER_LIMIT
            reset = r.reset_time
            assert await a.checkpoint.flush_once() == 1
            # "SIGKILL": a simply stops; a fresh instance boots warm
            b = await _instance(_conf(checkpoint_dir=d))
            assert await b.checkpoint.restore() == 1
            r2 = (await b.get_rate_limits([_req("hot", hits=0, limit=5)]))[0]
            assert r2.status == Status.OVER_LIMIT
            assert r2.reset_time == reset, "restore opened a fresh window"
            # restored windows are tracked: the next flush re-captures
            assert b.checkpoint.tracked_len == 1
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_stale_checkpoint_boots_cold(tmp_path, monkeypatch):
    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            await a.get_rate_limits([_req("hot", hits=9, limit=5)])
            await a.checkpoint.flush_once()
            clock.t += 301_000  # past GUBER_CHECKPOINT_MAX_AGE_MS
            before = _counter(metrics.CHECKPOINT_FAILURES, what="stale")
            b = await _instance(_conf(checkpoint_dir=d))
            assert await b.checkpoint.restore() == 0
            assert _counter(
                metrics.CHECKPOINT_FAILURES, what="stale"
            ) == before + 1
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_zero_max_age_disables_the_gate(tmp_path, monkeypatch):
    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            await a.get_rate_limits(
                [_req("hot", hits=9, limit=5, duration=600_000)]
            )
            await a.checkpoint.flush_once()
            clock.t += 400_000  # stale by the default bound, window live
            b = await _instance(
                _conf(checkpoint_dir=d, checkpoint_max_age=0.0)
            )
            assert await b.checkpoint.restore() == 1
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_torn_file_boots_cold_never_crashes(tmp_path):
    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            await a.get_rate_limits([_req("hot", hits=9, limit=5)])
            await a.checkpoint.flush_once()
            p = os.path.join(d, "chunk-0000.json")
            with open(p, "r+b") as f:
                f.truncate(os.path.getsize(p) // 2)
            before = _counter(metrics.CHECKPOINT_FAILURES, what="corrupt")
            b = await _instance(_conf(checkpoint_dir=d))
            assert await b.checkpoint.restore() == 0
            assert _counter(
                metrics.CHECKPOINT_FAILURES, what="corrupt"
            ) == before + 1
            # cold but SERVING: the fresh window admits
            r = (await b.get_rate_limits([_req("hot", hits=1, limit=5)]))[0]
            assert r.error == "" and r.status == Status.UNDER_LIMIT
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_version_skew_boots_cold(tmp_path):
    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            await a.get_rate_limits([_req("hot", hits=9, limit=5)])
            await a.checkpoint.flush_once()
            mp = os.path.join(d, "manifest.json")
            with open(mp) as f:
                m = json.load(f)
            m["format_version"] = ckpt_mod.FORMAT_VERSION + 7
            with open(mp, "w") as f:
                json.dump(m, f)
            before = _counter(metrics.CHECKPOINT_FAILURES, what="version")
            b = await _instance(_conf(checkpoint_dir=d))
            assert await b.checkpoint.restore() == 0
            assert _counter(
                metrics.CHECKPOINT_FAILURES, what="version"
            ) == before + 1
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_install_purges_stale_shed_verdict(tmp_path):
    """Satellite: a restored OVER window must not be shadowed by a
    pre-restore cached refusal — the bulk install path goes through
    Instance.update_peer_globals, whose shed purge fires for every
    installed key."""

    async def run():
        conf = _conf(
            checkpoint_dir=str(tmp_path), shed_cache=True,
            shed_cache_keys=128,
        )
        inst = await _instance(conf)
        try:
            # drain to zero, then freeze the refusal into the shed
            # cache (a frozen entry needs OVER_LIMIT with remaining 0)
            r0 = (await inst.get_rate_limits(
                [_req("shedk", hits=5, limit=5)]
            ))[0]
            assert r0.remaining == 0
            r = (await inst.get_rate_limits(
                [_req("shedk", hits=1, limit=5)]
            ))[0]
            assert r.status == Status.OVER_LIMIT and r.remaining == 0
            old_reset = r.reset_time
            assert inst.shed is not None and len(inst.shed) == 1
            # a restore install arrives for the same key with a NEWER
            # window (as after a restart whose checkpoint outlives the
            # cached verdict)
            now = millisecond_now()
            snap = _snap(
                _req("shedk").hash_key(), remaining=0,
                reset_time=old_reset + 30_000, now=now,
            )
            await inst.checkpoint.install("restore:test", [snap])
            # the stale cached verdict is GONE: the next answer carries
            # the restored window's reset_time, not the pre-install one
            r2 = (await inst.get_rate_limits(
                [_req("shedk", hits=1, limit=5)]
            ))[0]
            assert r2.status == Status.OVER_LIMIT
            assert r2.reset_time == old_reset + 30_000, (
                "stale shed-cache verdict served over the restored "
                "window"
            )
        finally:
            await inst.stop()

    asyncio.run(run())


# -- blue-green import marker protocol ---------------------------------------


def test_import_owned_installs_and_duplicate_delivery_noops():
    async def run():
        inst = await _instance(_conf(checkpoint_dir="/nonexistent-off"))
        try:
            now = millisecond_now()
            snap = _snap(_req("bg1").hash_key(), remaining=0,
                         reset_time=now + 40_000, now=now)
            await inst.checkpoint.install_import("import:blue:81", [snap])
            r = (await inst.get_rate_limits([_req("bg1", hits=0)]))[0]
            assert r.status == Status.OVER_LIMIT
            assert r.reset_time == now + 40_000
            # double delivery (every interval re-exports): a no-op
            await inst.checkpoint.install_import("import:blue:81", [snap])
            r2 = (await inst.get_rate_limits([_req("bg1", hits=0)]))[0]
            assert (r2.status, r2.remaining, r2.reset_time) == (
                r.status, r.remaining, r.reset_time
            )
        finally:
            await inst.stop()

    asyncio.run(run())


def test_import_nonowned_parks_and_seeds_on_ring_flip():
    """importfwd rows for keys this node does not own yet park in the
    LWW pending table; once the ring flips to make this node the
    owner, the first touch seeds the parked window (never a fresh
    one)."""
    from tests._util import free_ports

    async def run():
        conf = _conf(checkpoint_dir="/nonexistent-off")
        inst = await _instance(conf)
        try:
            # a second (dead) peer takes part of the ring; find a key
            # the DEAD peer owns
            for port in free_ports(16):
                dead = f"127.0.0.1:{port}"
                await inst.set_peers([
                    PeerInfo(address=ADDR, is_owner=True),
                    PeerInfo(address=dead, is_owner=False),
                ])
                key = next(
                    (f"bgp{i}" for i in range(200)
                     if not inst.get_peer(
                         _req(f"bgp{i}").hash_key()).is_owner),
                    None,
                )
                if key is not None:
                    break
            assert key is not None
            now = millisecond_now()
            newer = _snap(_req(key).hash_key(), remaining=0,
                          reset_time=now + 50_000, snapshot_ms=now + 1,
                          now=now)
            older = _snap(_req(key).hash_key(), remaining=3,
                          reset_time=now + 20_000, snapshot_ms=now,
                          now=now)
            # an importfwd batch is NEVER re-forwarded: the row parks
            await inst.checkpoint.install_import(
                "importfwd:blue:81", [newer]
            )
            assert inst.checkpoint.pending_len == 1
            # LWW: the older duplicate loses
            await inst.checkpoint.install_import(
                "importfwd:blue:81", [older]
            )
            assert inst.checkpoint.pending_len == 1
            parked = inst.checkpoint._pending[_req(key).hash_key()]
            assert parked.reset_time == now + 50_000
            # ring flips: this node now owns the key; the first touch
            # seeds the parked window
            await inst.set_peers([
                PeerInfo(address=ADDR, is_owner=True)
            ])
            r = (await inst.get_rate_limits([_req(key, hits=1)]))[0]
            assert r.status == Status.OVER_LIMIT
            assert r.reset_time == now + 50_000
            assert r.metadata["replicated"] == "true"
            assert inst.checkpoint.pending_len == 0
        finally:
            await inst.stop()

    asyncio.run(run())


def test_blue_green_export_over_real_grpc(tmp_path):
    """End-to-end cutover: the blue fleet's export lands the window on
    the green fleet over the real ReplicateBuckets door, and green
    answers OVER with blue's window before ever seeing the key."""
    from tests._util import free_ports
    from gubernator_tpu_torch.serve.server import PeersV1Servicer

    async def run():
        port = next(iter(free_ports(1)))
        green_addr = f"127.0.0.1:{port}"
        green_conf = _conf(checkpoint_dir=str(tmp_path / "green"))
        green_conf.grpc_address = green_addr
        green_conf.advertise_address = green_addr
        green = await _instance(green_conf)
        blue = await _instance(_conf(
            checkpoint_dir=str(tmp_path / "blue"),
            checkpoint_export_peers=[green_addr],
        ))
        server = grpc.aio.server()
        add_peers_servicer(server, PeersV1Servicer(green))
        assert server.add_insecure_port(green_addr) != 0
        await server.start()
        try:
            r = (await blue.get_rate_limits(
                [_req("cutover", hits=9, limit=5)]
            ))[0]
            assert r.status == Status.OVER_LIMIT
            await blue.checkpoint.flush_once()  # interval tick / drain
            g = (await green.get_rate_limits(
                [_req("cutover", hits=0, limit=5)]
            ))[0]
            assert g.status == Status.OVER_LIMIT
            assert g.reset_time == r.reset_time
        finally:
            await server.stop(None)
            await blue.stop()
            await green.stop()

    asyncio.run(run())


# -- fault injection ---------------------------------------------------------


def test_hung_checkpoint_write_never_blocks_serving(tmp_path):
    async def run():
        FAULTS.configure("checkpoint_write:hang")
        conf = _conf(checkpoint_dir=str(tmp_path))
        conf.checkpoint_interval = 0.02
        inst = await _instance(conf)
        try:
            await inst.get_rate_limits([_req("hk", hits=9, limit=5)])
            inst.checkpoint.kick()
            await asyncio.sleep(0.1)  # the flush loop is now parked
            for i in range(20):
                r = (await inst.get_rate_limits(
                    [_req("hk", hits=1, limit=5)]
                ))[0]
                assert r.error == "" and r.status == Status.OVER_LIMIT
            # the hang really fired (not a vacuous pass)
            assert _counter(
                metrics.FAULTS_INJECTED,
                point="checkpoint_write", action="hang",
            ) >= 1
            # and nothing landed on disk while parked
            assert not os.path.exists(
                os.path.join(str(tmp_path), "manifest.json")
            )
        finally:
            FAULTS.clear()
            await inst.stop()

    asyncio.run(run())


def test_checkpoint_write_error_counts_and_serving_continues(tmp_path):
    async def run():
        conf = _conf(checkpoint_dir=str(tmp_path))
        inst = await _instance(conf)
        try:
            await inst.get_rate_limits([_req("we", hits=1, limit=5)])
            FAULTS.configure("checkpoint_write:error")
            before = _counter(metrics.CHECKPOINT_FAILURES, what="write")
            await inst.checkpoint.flush_once()  # must not raise
            assert _counter(
                metrics.CHECKPOINT_FAILURES, what="write"
            ) == before + 1
            FAULTS.clear()
            # recovery: the next flush writes a usable checkpoint
            await inst.checkpoint.flush_once()
            manifest, snaps, _ = read_checkpoint(str(tmp_path))
            assert manifest["windows"] == len(snaps) == 1
        finally:
            FAULTS.clear()
            await inst.stop()

    asyncio.run(run())


def test_checkpoint_read_fault_boots_cold(tmp_path):
    async def run():
        d = str(tmp_path)
        a = await _instance(_conf(checkpoint_dir=d))
        b = None
        try:
            await a.get_rate_limits([_req("rf", hits=9, limit=5)])
            await a.checkpoint.flush_once()
            FAULTS.configure("checkpoint_read:error")
            before = _counter(metrics.CHECKPOINT_FAILURES, what="read")
            b = await _instance(_conf(checkpoint_dir=d))
            assert await b.checkpoint.restore() == 0
            assert _counter(
                metrics.CHECKPOINT_FAILURES, what="read"
            ) == before + 1
            r = (await b.get_rate_limits([_req("rf", hits=0)]))[0]
            assert r.error == ""
        finally:
            FAULTS.clear()
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_fault_spec_grammar_knows_checkpoint_points():
    from gubernator_tpu_torch.serve.faults import parse_fault_spec

    rules = parse_fault_spec(
        "checkpoint_write:delay=50ms,checkpoint_read:error"
    )
    assert [(r.point, r.action) for r in rules] == [
        ("checkpoint_write", "delay"), ("checkpoint_read", "error"),
    ]
    with pytest.raises(ValueError, match="unknown fault point"):
        parse_fault_spec("checkpoint_flush:error")


# -- all-algorithm restore property ------------------------------------------


def _mixed_reqs(n=32, duration=60_000):
    """Every algorithm, with some keys driven past their limit."""
    reqs = []
    for i in range(n):
        algo = Algorithm(i % 4)
        over = (i % 8) >= 4
        reqs.append(RateLimitReq(
            name="ckpt", unique_key=f"mx{i}",
            hits=9 if over else 2, limit=5 if over else 10,
            duration=duration, algorithm=algo,
        ))
    return reqs


def _device_conf(tmp_path):
    c = _conf(checkpoint_dir=str(tmp_path), backend="tpu")
    return c


def test_restore_all_algorithms_at_least_as_restrictive(tmp_path, monkeypatch):
    """The satellite property, pinned byte-exact: every restored
    window (token, leaky, sliding, GCRA — the full-lane section)
    answers EXACTLY what the pre-kill window answered at the same
    clock; restored remaining never exceeds the pre-kill oracle."""
    clock = FakeClock()
    _pin(monkeypatch, clock)

    def be():
        return TorchBackend(
            StoreConfig(rows=16, slots=1 << 10), buckets=(16, 64), device="cpu"
        )

    async def run():
        a = await _instance(_device_conf(tmp_path), backend=be())
        b = None
        try:
            reqs = _mixed_reqs()
            await a.get_rate_limits(reqs)
            clock.t += 500
            await a.get_rate_limits(reqs)  # second round: real state
            peeks = [
                RateLimitReq(
                    name="ckpt", unique_key=r.unique_key, hits=0,
                    limit=r.limit, duration=r.duration,
                    algorithm=r.algorithm,
                ) for r in reqs
            ]
            oracle = await a.get_rate_limits(peeks)
            await a.checkpoint.flush_once()
            # SIGKILL the fleet; a new process restores from disk
            b = await _instance(_device_conf(tmp_path), backend=be())
            # not every request persists a window (a refusal on the
            # insufficient-remaining path stores nothing), but most do
            restored = await b.checkpoint.restore()
            assert restored >= len(reqs) * 3 // 4
            got = await b.get_rate_limits(peeks)
            for r, x, y in zip(reqs, oracle, got):
                _assert_same(x, y, r)
                assert y.remaining <= x.remaining
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def _port_mesh_backend(n=8):
    from gubernator_tpu_torch.serve.backends import MeshBackend

    return MeshBackend(StoreConfig(rows=4, slots=256), devices=["cpu"] * n, buckets=(16, 64))


def test_restore_all_algorithms_at_least_as_restrictive_on_the_mesh(tmp_path, monkeypatch):
    """The mesh case of the same property (8 shards on the CPU): every
    restored window of every algorithm answers exactly what it answered
    before the kill, and no restored remaining exceeds the oracle's."""
    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def run():
        a = await _instance(_device_conf(tmp_path), backend=_port_mesh_backend())
        b = None
        try:
            reqs = _mixed_reqs()
            await a.get_rate_limits(reqs)
            clock.t += 500
            await a.get_rate_limits(reqs)
            peeks = [
                RateLimitReq(name="ckpt", unique_key=r.unique_key, hits=0, limit=r.limit,
                             duration=r.duration, algorithm=r.algorithm)
                for r in reqs
            ]
            oracle = await a.get_rate_limits(peeks)
            await a.checkpoint.flush_once()
            b = await _instance(_device_conf(tmp_path), backend=_port_mesh_backend())
            assert await b.checkpoint.restore() >= len(reqs) * 3 // 4
            got = await b.get_rate_limits(peeks)
            for r, x, y in zip(reqs, oracle, got):
                _assert_same(x, y, r)
                assert y.remaining <= x.remaining
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


def test_restore_across_shard_count_change(tmp_path, monkeypatch):
    """Restore is also a re-partition: a checkpoint taken under an 8-shard
    mesh restores byte-exact into a 4-shard mesh (the lanes install routes
    by hash under the current policy)."""
    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def run():
        a = await _instance(_device_conf(tmp_path), backend=_port_mesh_backend(8))
        b = None
        try:
            reqs = _mixed_reqs()
            await a.get_rate_limits(reqs)
            peeks = [
                RateLimitReq(name="ckpt", unique_key=r.unique_key, hits=0, limit=r.limit,
                             duration=r.duration, algorithm=r.algorithm)
                for r in reqs
            ]
            oracle = await a.get_rate_limits(peeks)
            await a.checkpoint.flush_once()
            b = await _instance(_device_conf(tmp_path), backend=_port_mesh_backend(4))
            assert b.backend.engine.n == 4
            assert await b.checkpoint.restore() >= len(reqs) * 3 // 4
            got = await b.get_rate_limits(peeks)
            for r, x, y in zip(reqs, oracle, got):
                _assert_same(x, y, r)
        finally:
            await a.stop()
            if b is not None:
                await b.stop()

    asyncio.run(run())


# -- differential identity: checkpoint ON == OFF -----------------------------


def _jax_conf(**kw):
    from gubernator_tpu.serve.config import BehaviorConfig as JB
    from gubernator_tpu.serve.config import ServerConfig as JS

    conf = JS(
        grpc_address=ADDR, advertise_address=ADDR, backend="exact",
        behaviors=JB(
            peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3,
            breaker_cooldown=0.2,
        ),
    )
    conf.checkpoint_interval = 60.0
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


async def _jax_instance(conf, backend):
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.serve.instance import Instance as JInstance

    inst = JInstance(conf, backend)
    inst.start()
    await inst.set_peers([jt.PeerInfo(address=conf.advertise_address, is_owner=True)])
    return inst


def _ckpt_files(d):
    """{name: bytes} of one checkpoint directory."""
    return {
        fn: open(os.path.join(d, fn), "rb").read()
        for fn in sorted(os.listdir(d))
    }


async def _ckpt_fuzz_pair(mk_backend, mk_jax_backend, clock, steps, seed, tmp_path):
    """ON and OFF port twins plus the JAX package's ON twin, identical
    single-node ring, only the knob (or the package) differs; both ON
    twins flush (disk write + lanes gather) every 25 steps. Responses
    must stay byte-identical (captures are non-mutating and writes
    happen off the request path), and the port's checkpoint files must
    be byte for byte the JAX package's after every flush."""
    keys = [f"cf{i}" for i in range(12)]

    async def mk(ckpt_dir):
        conf = _conf(checkpoint_dir=ckpt_dir)
        inst = Instance(conf, mk_backend())
        inst.start()
        await inst.set_peers([PeerInfo(address=ADDR, is_owner=True)])
        return inst

    on = await mk(str(tmp_path / "port"))
    off = await mk("")
    twin = await _jax_instance(
        _jax_conf(checkpoint_dir=str(tmp_path / "jax")), mk_jax_backend()
    )
    assert on.checkpoint is not None and off.checkpoint is None
    try:
        rng = np.random.default_rng(seed)
        flushed = 0
        for step, batch, dt in _fuzz_stream(rng, keys, steps):
            clock.t += dt
            a = await on.get_rate_limits(batch)
            b = await off.get_rate_limits(batch)
            c = await twin.get_rate_limits([_jax_req(r) for r in batch])
            for x, y, z, r in zip(a, b, c, batch):
                _assert_same(x, y, (step, r))
                _assert_same(x, z, (step, r, "jax"))
            if step % 25 == 24:
                n = await on.checkpoint.flush_once()
                assert n == await twin.checkpoint.flush_once()
                flushed += n
                assert _ckpt_files(tmp_path / "port") == _ckpt_files(tmp_path / "jax")
        assert flushed > 0, "fuzz never captured a tracked window"
        if hasattr(on.backend, "engine"):
            assert any(f.startswith("lanes-") for f in _ckpt_files(tmp_path / "port"))
    finally:
        await on.stop()
        await off.stop()
        await twin.stop()


@pytest.mark.parametrize("seed", [3, 11])
def test_differential_identity_fuzz_exact(tmp_path, monkeypatch, seed):
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend

    clock = FakeClock()
    _pin(monkeypatch, clock)
    asyncio.run(_ckpt_fuzz_pair(
        lambda: ExactBackend(10_000), lambda: JExactBackend(10_000),
        clock, 250, seed, tmp_path,
    ))


def _jax_device_backend():
    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import TpuBackend as JTpuBackend

    return JTpuBackend(JStoreConfig(rows=16, slots=1 << 10), buckets=(16, 64))


def _port_device_backend():
    return TorchBackend(StoreConfig(rows=16, slots=1 << 10), buckets=(16, 64),
                        device="cpu")


def test_differential_identity_fuzz_device(tmp_path, monkeypatch):
    clock = FakeClock()
    _pin(monkeypatch, clock)
    asyncio.run(_ckpt_fuzz_pair(
        _port_device_backend, _jax_device_backend, clock, 100, 5, tmp_path
    ))


def test_differential_identity_fuzz_mesh(tmp_path, monkeypatch):
    """ON == OFF through the 8-shard port mesh, answering and writing
    checkpoint files byte for byte as the JAX package's 8-device mesh."""
    import jax

    from gubernator_tpu.core.store import StoreConfig as JStoreConfig
    from gubernator_tpu.serve.backends import MeshBackend as JMeshBackend

    clock = FakeClock()
    _pin(monkeypatch, clock)
    asyncio.run(_ckpt_fuzz_pair(
        _port_mesh_backend,
        lambda: JMeshBackend(JStoreConfig(rows=4, slots=256), devices=jax.devices(),
                             buckets=(16, 64)),
        clock, 60, 7, tmp_path,
    ))


# -- restores across the two packages ------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, monkeypatch, writer):
    """A checkpoint written by one package's Instance (device backend, all
    four algorithms, some over their limits) restores in the other's, and
    every answer after the restore (peeks, then charges, then peeks) is
    identical to the writer's own answers to the same requests."""
    from gubernator_tpu.api import types as jt

    clock = FakeClock()
    _pin(monkeypatch, clock)
    d = str(tmp_path / "ckpt")

    def mk_port():
        return _instance(_conf(checkpoint_dir=d, backend="tpu"), _port_device_backend())

    def mk_jax():
        return _jax_instance(_jax_conf(checkpoint_dir=d, backend="tpu"),
                             _jax_device_backend())

    def as_pkg(inst, reqs):
        return reqs if isinstance(inst, Instance) else [_jax_req(r) for r in reqs]

    async def run():
        mk_w, mk_r = (mk_jax, mk_port) if writer == "jax" else (mk_port, mk_jax)
        w = await mk_w()
        rd = None
        try:
            reqs = _mixed_reqs()
            await w.get_rate_limits(as_pkg(w, reqs))
            clock.t += 500
            await w.get_rate_limits(as_pkg(w, reqs))
            await w.checkpoint.flush_once()
            rd = await mk_r()
            restored = await rd.checkpoint.restore()
            assert restored >= len(reqs) * 3 // 4
            peeks = [
                RateLimitReq(name="ckpt", unique_key=r.unique_key, hits=0,
                             limit=r.limit, duration=r.duration, algorithm=r.algorithm)
                for r in reqs
            ]
            ones = [
                RateLimitReq(name="ckpt", unique_key=r.unique_key, hits=1,
                             limit=r.limit, duration=r.duration, algorithm=r.algorithm)
                for r in reqs
            ]
            for batch, dt in ((peeks, 0), (ones, 10), (peeks, 2000)):
                clock.t += dt
                x = await w.get_rate_limits(as_pkg(w, batch))
                y = await rd.get_rate_limits(as_pkg(rd, batch))
                for a, b, r in zip(x, y, batch):
                    _assert_same(a, b, r)
            assert any(int(a.status) == int(jt.Status.OVER_LIMIT) for a in x)
            # the reader's store now holds the writer's windows. The two
            # engines' clocks have different epochs: the export converts
            # the expiry lane to unix-ms, but the `ts` lane is carried raw
            # (engine-ms where an algorithm keeps a time there), in both
            # packages, so it is left out of this comparison
            ew = w.backend.engine.export_windows(clock.t)
            er = rd.backend.engine.export_windows(clock.t)
            ow, orr = np.argsort(ew["key_hash"]), np.argsort(er["key_hash"])
            for col in ew:
                if col != "ts":
                    np.testing.assert_array_equal(ew[col][ow], er[col][orr], err_msg=col)
        finally:
            await w.stop()
            if rd is not None:
                await rd.stop()

    asyncio.run(run())


def test_exact_checkpoint_restores_across_packages(tmp_path, monkeypatch):
    """The exact backend's checkpoint (tracked token rows only, no lanes)
    written by the JAX package restores in the port and vice versa."""
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend

    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def run():
        for wmk, rmk, tag in (
            (lambda d: _jax_instance(_jax_conf(checkpoint_dir=d), JExactBackend(1000)),
             lambda d: _instance(_conf(checkpoint_dir=d)), "j2t"),
            (lambda d: _instance(_conf(checkpoint_dir=d)),
             lambda d: _jax_instance(_jax_conf(checkpoint_dir=d), JExactBackend(1000)), "t2j"),
        ):
            d = str(tmp_path / tag)
            w = await wmk(d)
            rd = None
            try:
                reqs = [_req(f"ex{i}", hits=(9 if i % 3 == 0 else 2), limit=5)
                        for i in range(40)]
                x0 = await w.get_rate_limits(
                    reqs if isinstance(w, Instance) else [_jax_req(r) for r in reqs])
                assert await w.checkpoint.flush_once() == 40
                rd = await rmk(d)
                assert await rd.checkpoint.restore() == 40
                peeks = [_req(f"ex{i}", hits=1, limit=5) for i in range(40)]
                x = await w.get_rate_limits(
                    peeks if isinstance(w, Instance) else [_jax_req(r) for r in peeks])
                y = await rd.get_rate_limits(
                    peeks if isinstance(rd, Instance) else [_jax_req(r) for r in peeks])
                for a, b, r in zip(x, y, peeks):
                    _assert_same(a, b, r)
                assert sum(int(a.status) for a in x0) > 0
            finally:
                await w.stop()
                if rd is not None:
                    await rd.stop()

    asyncio.run(run())


# -- manager tables / config gates -------------------------------------------


def test_tracked_eviction_keeps_freshest():
    async def run():
        conf = _conf(checkpoint_dir="/x", checkpoint_track_keys=2)
        m = CheckpointManager(conf, None)
        m.note_owned(_req("a"))
        m.note_owned(_req("b"))
        m.note_owned(_req("a"))  # refresh: b is now stalest
        m.note_owned(_req("c"))
        assert sorted(m._tracked) == sorted(
            [_req("a").hash_key(), _req("c").hash_key()]
        )
        # peeks and non-token algorithms never track
        m.note_owned(_req("d", hits=0))
        m.note_owned(_req("e", algo=Algorithm.LEAKY_BUCKET))
        assert len(m._tracked) == 2

    asyncio.run(run())


def test_checkpoint_refused_without_snapshot_surface():
    class _NoSnap:
        inline_decide = True

        def decide(self, reqs, gnp, now=None):  # pragma: no cover
            return []

    with pytest.raises(ValueError, match="GUBER_CHECKPOINT"):
        Instance(_conf(checkpoint_dir="/x"), _NoSnap())


def test_config_knobs_parse_and_validate():
    from gubernator_tpu_torch.serve.config import config_from_env

    conf = config_from_env({
        "GUBER_CHECKPOINT_DIR": "/var/lib/guber/ckpt",
        "GUBER_CHECKPOINT_INTERVAL_MS": "2500",
        "GUBER_CHECKPOINT_MAX_AGE_MS": "120000",
        "GUBER_CHECKPOINT_TRACK_KEYS": "1024",
        "GUBER_CHECKPOINT_EXPORT_PEERS": "10.0.0.9:81, 10.0.0.10:81",
    })
    assert conf.checkpoint_dir == "/var/lib/guber/ckpt"
    assert conf.checkpoint_interval == 2.5
    assert conf.checkpoint_max_age == 120.0
    assert conf.checkpoint_track_keys == 1024
    assert conf.checkpoint_export_peers == [
        "10.0.0.9:81", "10.0.0.10:81"
    ]
    with pytest.raises(ValueError, match="GUBER_CHECKPOINT_INTERVAL_MS"):
        config_from_env({"GUBER_CHECKPOINT_INTERVAL_MS": "0"})
    with pytest.raises(ValueError, match="GUBER_CHECKPOINT_MAX_AGE_MS"):
        config_from_env({"GUBER_CHECKPOINT_MAX_AGE_MS": "-1"})
    with pytest.raises(ValueError, match="GUBER_CHECKPOINT_TRACK_KEYS"):
        config_from_env({"GUBER_CHECKPOINT_TRACK_KEYS": "0"})
