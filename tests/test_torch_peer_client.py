"""The port's PeerClient against the JAX package's, on the CPU.

Mirrors tests/test_peer_client.py and the peer half of
tests/test_resilience.py: every scenario drives the port's
`PeerClient` and the JAX one against the same fake PeersV1 stub and must
give the same outcome (the RPC batches the stub saw, the answers, the
error raised and its message) — the micro-batch flusher (flush at
batch_limit without waiting, flush at the batch_wait window, whole-batch
failure fan-back, response-count mismatch, close() failing queued
callers), the retry classification and budget, the deadline and the
circuit breaker, and bucket replication's ReplicateBuckets send (the
request the stub saw, its retry). Then the instance-level envelope on a CPU TorchBackend:
per-item errors for an unreachable owner, degraded mode, breaker-aware
health. Tolerance is zero.
"""

import asyncio

import grpc
import pytest

import gubernator_tpu.serve.peers as j_peers
import gubernator_tpu_torch.serve.peers as t_peers
from gubernator_tpu.serve.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu_torch.api import convert
from gubernator_tpu_torch.api.proto.gen import peers_pb2
from gubernator_tpu_torch.api.types import (
    Behavior,
    PeerInfo,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import TorchBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance

SIDES = {"torch": (t_peers, BehaviorConfig), "jax": (j_peers, JBehaviorConfig)}


def _req(i: int, hits: int = 1) -> RateLimitReq:
    return RateLimitReq(
        name="pc", unique_key=f"k{i}", hits=hits, limit=10, duration=1000,
        behavior=Behavior.BATCHING,
    )


class _UnavailableError(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE

    def __str__(self):
        return "unavailable"


class FakeStub:
    """Records each GetPeerRateLimits batch on entry; answers remaining=7
    per request, or fails as told."""

    def __init__(self, fail=(), short=False, hang=False):
        self.batches = []
        self.fail = list(fail)  # exceptions raised by the next calls
        self.short = short
        self.hang = hang
        self.release = asyncio.Event()
        self.release.set()

    async def GetPeerRateLimits(self, pb_req, timeout=None):
        self.batches.append([r.unique_key for r in pb_req.requests])
        if self.hang:
            await asyncio.Event().wait()
        await self.release.wait()
        if self.fail:
            raise self.fail.pop(0)
        n = len(pb_req.requests) - (1 if self.short else 0)
        return peers_pb2.GetPeerRateLimitsResp(
            rate_limits=[
                convert.resp_to_pb(RateLimitResp(limit=10, remaining=7))
                for _ in range(n)
            ]
        )


    async def ReplicateBuckets(self, pb_req, timeout=None):
        self.batches.append((pb_req.owner, [
            (b.key, b.algorithm, b.limit, b.duration, b.remaining,
             b.reset_time, b.status, b.snapshot_ms)
            for b in pb_req.buckets
        ]))
        if self.fail:
            raise self.fail.pop(0)
        return peers_pb2.ReplicateBucketsResp()


def _client(side, stub, flusher=True, **kw):
    mod, conf_cls = SIDES[side]
    c = mod.PeerClient(conf_cls(**kw), "127.0.0.1:1")
    c.stub = stub
    if flusher:
        c._flusher = asyncio.ensure_future(c._run())
    return c


async def _outcome(coro):
    """(kind, value) of an awaited call: its answers, or its error."""
    try:
        out = await asyncio.wait_for(coro, timeout=5)
    except Exception as e:  # the error's class name and message
        return ("raised", type(e).__name__, str(e))
    if out is None:  # a send with no answer (ReplicateBuckets)
        return ("ok", None)
    if isinstance(out, list):
        return ("ok", [(r.remaining, r.limit, r.error) for r in out])
    return ("ok", (out.remaining, out.limit, out.error))


async def _flush_at_limit(side):
    stub = FakeStub()
    # a long window that must NOT be waited out once the limit hits
    c = _client(side, stub, batch_wait=5.0, batch_limit=3)
    stub.release.clear()  # hold the RPC so the queue accumulates
    futs = [asyncio.ensure_future(c.get_peer_rate_limit(_req(i))) for i in range(3)]
    await asyncio.sleep(0.05)
    stub.release.set()
    out = [await _outcome(f) for f in futs]
    await c.close()
    return stub.batches, out


async def _flush_at_window(side):
    stub = FakeStub()
    c = _client(side, stub, batch_wait=0.02, batch_limit=100)
    out = await _outcome(c.get_peer_rate_limit(_req(0)))
    await c.close()
    return stub.batches, out


async def _failure_fans_back(side):
    stub = FakeStub(fail=[RuntimeError("owner exploded")])
    stub.release.clear()
    c = _client(side, stub, batch_wait=0.005, batch_limit=10)
    futs = [asyncio.ensure_future(c.get_peer_rate_limit(_req(i))) for i in range(4)]
    await asyncio.sleep(0.02)
    stub.release.set()
    out = [await _outcome(f) for f in futs]
    out.append(await _outcome(c.get_peer_rate_limit(_req(9))))  # flusher survives
    await c.close()
    return stub.batches, out


async def _count_mismatch(side):
    stub = FakeStub(short=True)
    c = _client(side, stub, batch_wait=0, batch_limit=10)
    out = await _outcome(c.get_peer_rate_limit(_req(0)))
    await c.close()
    return stub.batches, out


async def _enqueue_after_close(side):
    stub = FakeStub()
    c = _client(side, stub, batch_wait=0, batch_limit=10)
    await c.close()
    return stub.batches, await _outcome(c.get_peer_rate_limit(_req(0)))


async def _close_fails_queued(side):
    stub = FakeStub()
    stub.release.clear()  # the first RPC parks the flusher mid-send
    c = _client(side, stub, batch_wait=0, batch_limit=1)
    f1 = asyncio.ensure_future(c.get_peer_rate_limit(_req(0)))
    while not stub.batches:
        await asyncio.sleep(0.001)
    f2 = asyncio.ensure_future(c.get_peer_rate_limit(_req(1)))
    await asyncio.sleep(0.01)
    await c.close()
    return stub.batches, [await _outcome(f1), await _outcome(f2)]


_RETRY = dict(peer_retries=2, peer_backoff=0.001, peer_backoff_max=0.002)


async def _retry_masks_unavailable(side):
    stub = FakeStub(fail=[_UnavailableError(), _UnavailableError()])
    c = _client(side, stub, flusher=False, **_RETRY)
    return stub.batches, await _outcome(c.get_peer_rate_limits([_req(0)]))


async def _retry_budget_exhausted(side):
    stub = FakeStub(fail=[_UnavailableError() for _ in range(9)])
    c = _client(side, stub, flusher=False, **_RETRY)
    return stub.batches, await _outcome(c.get_peer_rate_limits([_req(0)]))


async def _no_retry_of_hits(side):
    stub = FakeStub(fail=[RuntimeError("application error")])
    c = _client(side, stub, flusher=False, **_RETRY)
    return stub.batches, await _outcome(c.get_peer_rate_limits([_req(0)]))


async def _peek_retries_anything(side):
    stub = FakeStub(fail=[RuntimeError("transient application error")])
    c = _client(side, stub, flusher=False, **_RETRY)
    return stub.batches, await _outcome(c.get_peer_rate_limits([_req(0, hits=0)]))


async def _deadline_bounds_hang(side):
    stub = FakeStub(hang=True)
    c = _client(side, stub, flusher=False, peer_timeout=0.05, peer_retries=0)
    t0 = asyncio.get_running_loop().time()
    out = await _outcome(c.get_peer_rate_limits([_req(0)]))
    return stub.batches, out, asyncio.get_running_loop().time() - t0 < 1.0


async def _breaker_fails_fast(side):
    stub = FakeStub(fail=[_UnavailableError() for _ in range(9)])
    c = _client(side, stub, flusher=False, peer_retries=0, breaker_failures=3,
                breaker_cooldown=60.0)
    out = [await _outcome(c.get_peer_rate_limits([_req(i)])) for i in range(4)]
    return stub.batches, out, c.breaker.state


async def _trip_raises_root_cause(side):
    stub = FakeStub(fail=[_UnavailableError() for _ in range(9)])
    c = _client(side, stub, flusher=False, peer_retries=5, breaker_failures=2,
                breaker_cooldown=60.0, peer_backoff=0.001, peer_backoff_max=0.002)
    return stub.batches, await _outcome(c.get_peer_rate_limits([_req(0)]))


def _snapshots():
    from gubernator_tpu_torch.serve.replication import Snapshot

    return [
        Snapshot(key=f"pc_k{i}", algorithm=0, limit=10, duration=60_000,
                 remaining=i, reset_time=1_700_000_060_000 + i, status=i % 2,
                 snapshot_ms=1_700_000_000_000)
        for i in range(3)
    ]


async def _replicate_sends(side):
    stub = FakeStub()
    c = _client(side, stub, flusher=False)
    out = await _outcome(c.replicate_buckets(_snapshots(), owner="10.0.0.1:81"))
    return stub.batches, out


async def _replicate_retries(side):
    stub = FakeStub(fail=[_UnavailableError(), _UnavailableError()])
    c = _client(side, stub, flusher=False, peer_retries=2, peer_backoff=0.001,
                peer_backoff_max=0.002)
    out = await _outcome(c.replicate_buckets(_snapshots()[:1], owner="import:b:81"))
    return stub.batches, out


SCENARIOS = {
    "flush_at_batch_limit_without_waiting": _flush_at_limit,
    "flush_at_window_for_partial_batch": _flush_at_window,
    "batch_failure_fans_back_to_every_caller": _failure_fans_back,
    "response_count_mismatch_rejected": _count_mismatch,
    "enqueue_after_close_fails_fast": _enqueue_after_close,
    "close_fails_queued_callers_instead_of_stranding": _close_fails_queued,
    "retry_masks_transient_unavailable": _retry_masks_unavailable,
    "retry_budget_exhaustion_raises": _retry_budget_exhausted,
    "no_retry_for_nonretryable_on_hit_batch": _no_retry_of_hits,
    "peek_batch_retries_any_failure": _peek_retries_anything,
    "deadline_bounds_hung_stub": _deadline_bounds_hang,
    "breaker_fails_fast_after_trip": _breaker_fails_fast,
    "trip_failure_raises_root_cause_not_breaker_error": _trip_raises_root_cause,
    "replicate_buckets_sends_every_snapshot": _replicate_sends,
    "replicate_buckets_retries_unavailable": _replicate_retries,
}

#: what each scenario must show on both sides (the reference's contract)
EXPECT = {
    "flush_at_batch_limit_without_waiting": lambda o: (
        o[0] == [["k0", "k1", "k2"]] and o[1] == [("ok", (7, 10, ""))] * 3),
    "flush_at_window_for_partial_batch": lambda o: (
        o == ([["k0"]], ("ok", (7, 10, "")))),
    "batch_failure_fans_back_to_every_caller": lambda o: (
        all(x[0] == "raised" and "owner exploded" in x[2] for x in o[1][:4])
        and o[1][4] == ("ok", (7, 10, ""))),
    "response_count_mismatch_rejected": lambda o: "mismatched" in o[1][2],
    "enqueue_after_close_fails_fast": lambda o: (
        o[0] == [] and "is closed" in o[1][2]),
    "close_fails_queued_callers_instead_of_stranding": lambda o: all(
        "closed mid-batch" in x[2] for x in o[1]),
    "retry_masks_transient_unavailable": lambda o: (
        len(o[0]) == 3 and o[1] == ("ok", [(7, 10, "")])),
    "retry_budget_exhaustion_raises": lambda o: (
        len(o[0]) == 3 and o[1][:2] == ("raised", "_UnavailableError")),
    "no_retry_for_nonretryable_on_hit_batch": lambda o: (
        len(o[0]) == 1 and o[1][1] == "RuntimeError"),
    "peek_batch_retries_any_failure": lambda o: (
        len(o[0]) == 2 and o[1] == ("ok", [(7, 10, "")])),
    "deadline_bounds_hung_stub": lambda o: (
        o[1][:2] == ("raised", "TimeoutError") and o[2]),
    "breaker_fails_fast_after_trip": lambda o: (
        len(o[0]) == 3 and o[1][3][:2] == ("raised", "BreakerOpenError")
        and o[2] == "open"),
    "trip_failure_raises_root_cause_not_breaker_error": lambda o: (
        len(o[0]) == 2 and o[1][1] == "_UnavailableError"),
    "replicate_buckets_sends_every_snapshot": lambda o: (
        o[0] == [("10.0.0.1:81", [
            (f"pc_k{i}", 0, 10, 60_000, i, 1_700_000_060_000 + i, i % 2,
             1_700_000_000_000) for i in range(3)])]
        and o[1][0] == "ok"),
    "replicate_buckets_retries_unavailable": lambda o: (
        len(o[0]) == 3 and o[0][0][0] == "import:b:81" and o[1][0] == "ok"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_peer_client_matches_jax(name):
    torch_out = asyncio.run(SCENARIOS[name]("torch"))
    jax_out = asyncio.run(SCENARIOS[name]("jax"))
    assert torch_out == jax_out
    assert EXPECT[name](torch_out), torch_out


def test_is_retryable_classification_matches_jax():
    cases = [
        (_UnavailableError(), False), (ConnectionRefusedError(), False),
        (asyncio.TimeoutError(), False), (RuntimeError("boom"), False),
        (asyncio.TimeoutError(), True), (RuntimeError("boom"), True),
    ]
    got = [t_peers.is_retryable(e, all_peek=p) for e, p in cases]
    assert got == [j_peers.is_retryable(e, all_peek=p) for e, p in cases]
    assert got == [True, True, False, False, True, True]


def test_the_owner_opens_no_channel():
    """The client of this node itself dials nothing (a one-node ring
    needs no grpc); a remote peer's channel opens at connect, and a
    ReplicateBuckets send to a peer that is not listening fails with the
    peer's error (the manager counts and retries it)."""

    async def run():
        conf = BehaviorConfig()
        own = t_peers.PeerClient(conf, "127.0.0.1:1", is_owner=True)
        own.connect()
        remote = t_peers.PeerClient(conf, "127.0.0.1:2")
        remote.connect()
        try:
            assert own.channel is None and own.stub is None
            assert remote.channel is not None and remote.stub is not None
            with pytest.raises(ValueError, match="invalid peer address"):
                t_peers.PeerClient(conf, "nohost").connect()
            with pytest.raises(grpc.RpcError):
                await remote.replicate_buckets([], owner="x")
        finally:
            await own.close()
            await remote.close()

    asyncio.run(run())


# -- instance-level: per-item errors, degraded mode, health ---------------


def _conf(**kw) -> ServerConfig:
    conf = ServerConfig(
        grpc_address="127.0.0.1:1",
        advertise_address="127.0.0.1:1",
        behaviors=BehaviorConfig(
            peer_timeout=0.2, peer_retries=1, peer_backoff=0.001,
            peer_backoff_max=0.002, breaker_failures=3, breaker_cooldown=60.0,
        ),
        sketch=False,
    )
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


async def _instance_with_dead_peer(conf):
    """Instance whose keys partly route to a peer address nothing
    listens on (connect-refused surfaces at RPC time, like the
    reference). The port stays bound, without listen(), until the
    caller closes the returned socket: a free port released at once
    could be taken by another test's server while this one runs."""
    import socket

    hold = socket.socket()
    hold.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{hold.getsockname()[1]}"
    inst = Instance(conf, TorchBackend(StoreConfig(rows=4, slots=64), buckets=(64,),
                                       device="cpu"))
    inst.start()
    await inst.set_peers([
        PeerInfo(address=conf.advertise_address, is_owner=True),
        PeerInfo(address=dead, is_owner=False),
    ])
    keys = [r for r in (
        RateLimitReq(name="res", unique_key=f"k{i}", hits=1, limit=10, duration=60000)
        for i in range(256)
    ) if inst.get_peer(r.hash_key()).host == dead][:4]
    assert keys, "no key landed on the dead peer in 256 tries"
    return inst, dead, keys, hold


@pytest.mark.parametrize("mode", ["per_item_error", "degraded", "breaker_health"])
def test_instance_envelope_for_an_unreachable_owner(mode):
    async def run():
        inst, dead, keys, hold = await _instance_with_dead_peer(
            _conf(degraded_local=(mode == "degraded")))
        try:
            if mode == "per_item_error":
                for r in await inst.get_rate_limits(keys):
                    assert "from peer" in r.error  # per-item, not a 503
            elif mode == "degraded":
                for want in (9, 8):  # the hits land in the LOCAL store
                    for r in await inst.get_rate_limits(keys):
                        assert r.error == ""
                        assert r.metadata == {"degraded": "true", "owner": dead}
                        assert r.remaining == want
            else:
                assert inst.health_check().status == "healthy"
                for _ in range(3):  # 2 attempts a request trip 3 failures
                    await inst.get_rate_limits(keys[:1])
                h = inst.health_check()
                assert h.status == "unhealthy"
                assert "circuit open" in h.message and dead in h.message
                resp = (await inst.get_rate_limits(keys[:1]))[0]
                assert "circuit open" in resp.error
        finally:
            await inst.stop()
            hold.close()

    asyncio.run(run())
