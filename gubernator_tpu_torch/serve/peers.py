"""Peer routing: consistent-hash ownership + the batching peer RPC client
(the port of gubernator_tpu/serve/peers.py).

The ring is the reference's, copied: a crc32 point per peer, a sorted
ring, binary-search successor with wraparound (reference hash.go:62-96),
so a mixed cluster would agree on key ownership. Beside `get`, the
picker answers the successor query of bucket replication
(`get_successor`), the planned-handoff diff of ring rescale
(`ownership_diff`) and the edge bridge's ownership screen
(`self_owned_mask`).

PeerClient mirrors the reference's forwarding semantics (peers.go):
BATCHING/GLOBAL requests coalesce into micro-batches flushed every
`batch_wait` or at `batch_limit`; NO_BATCHING goes out as a direct unary
call. Implemented on asyncio instead of goroutines+channels: one flusher
task per peer, futures instead of response channels. Every call runs
inside the resilience envelope (deadline, per-peer circuit breaker,
bounded retry of what is safe to resend).

grpc, protobuf and the wire conversions load only when a client first
needs them (`connect` of a remote peer, or its first RPC): the client of
this node itself opens no channel, so a one-node Instance serves with
none of the three importable.
"""

from __future__ import annotations

import asyncio
import bisect
import logging
import random
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.api.types import Behavior, RateLimitReq, RateLimitResp
from gubernator_tpu_torch.core.hashing import ring_hash
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.aio import collect_batch
from gubernator_tpu_torch.serve.breaker import (
    OPEN as BREAKER_OPEN,
    BreakerOpenError,
    CircuitBreaker,
)
from gubernator_tpu_torch.serve.config import BehaviorConfig
from gubernator_tpu_torch.serve.faults import FAULTS, FaultError

log = logging.getLogger("gubernator_tpu_torch.peers")

_WIRE = None


def _wire():
    """(convert, peers_pb2), imported on first use."""
    global _WIRE
    if _WIRE is None:
        from gubernator_tpu_torch.api import convert
        from gubernator_tpu_torch.api.proto.gen import peers_pb2

        _WIRE = (convert, peers_pb2)
    return _WIRE


def is_retryable(exc: BaseException, all_peek: bool = False) -> bool:
    """Safe-to-resend classification for the peer retry policy.

    `all_peek=True` (every request in the batch carries hits=0) makes
    ANY failure retryable — re-running a peek is free. Otherwise only
    failures where the request never reached the peer's application
    layer qualify: gRPC UNAVAILABLE (connection refused / reset before
    dispatch), plain connection errors, and injected faults flagged
    retryable. DEADLINE_EXCEEDED and application errors are NOT safe —
    the peer may have already applied the hits, and a rate limiter that
    double-counts under partial failure is worse than one that errors.
    """
    if all_peek:
        return True
    if isinstance(exc, FaultError):
        return exc.retryable
    if isinstance(exc, ConnectionError):
        return True
    grpc = sys.modules.get("grpc")  # no RpcError exists before grpc loads
    if grpc is not None and isinstance(exc, grpc.RpcError):
        code = getattr(exc, "code", None)
        try:
            return callable(code) and code() == grpc.StatusCode.UNAVAILABLE
        except Exception:
            return False
    return False


class PeerClient:
    """Connection to one peer (possibly this server itself)."""

    def __init__(
        self,
        conf: BehaviorConfig,
        host: str,
        is_owner: bool = False,
        mesh_local: bool = False,
    ):
        self.conf = conf
        self.host = host
        self.is_owner = is_owner  # true when this peer is this server
        self.mesh_local = mesh_local
        self.channel = None  # grpc.aio.Channel once opened
        self.stub = None  # PeersV1Stub once opened
        # queue items are GROUPS: (reqs list, future resolving to the
        # matching resps list, traceparent). One future per group (r7
        # owner batching): a request batch forwarding hundreds of items
        # to one owner costs one enqueue + one future, not one per item.
        self._queue: "asyncio.Queue[Tuple[List[RateLimitReq], asyncio.Future, Optional[str]]]" = (  # noqa: E501
            asyncio.Queue()
        )
        # one-slot park for a group that would overflow the previous
        # batch (aio.collect_batch carry contract)
        self._carry: List = []
        self._flusher: Optional[asyncio.Task] = None
        self._closed = False
        # per-peer circuit breaker (r8): failures on THIS peer's RPCs
        # trip it; while open every call fails fast (BreakerOpenError)
        # instead of paying a deadline. State survives set_peers churn
        # because existing clients are reused there.
        self.breaker = self._make_breaker()

    def _make_breaker(self) -> Optional[CircuitBreaker]:
        c = self.conf
        if getattr(c, "breaker_failures", 0) <= 0:
            return None  # GUBER_BREAKER_FAILURES=0 disables

        def on_transition(frm: str, to: str) -> None:
            from gubernator_tpu_torch.serve.breaker import STATE_CODES

            log.warning("peer '%s' circuit breaker: %s -> %s", self.host, frm, to)
            try:
                metrics.PEER_BREAKER_TRANSITIONS.labels(peer=self.host, to=to).inc()
                metrics.PEER_BREAKER_STATE.labels(peer=self.host).set(STATE_CODES[to])
            except Exception:  # pragma: no cover - defensive
                pass

        return CircuitBreaker(
            failures=c.breaker_failures,
            ratio=c.breaker_ratio,
            window=c.breaker_window,
            cooldown=c.breaker_cooldown,
            probes=c.breaker_probes,
            on_transition=on_transition,
        )

    def connect(self) -> None:
        self._closed = False  # (re)opening
        if self.channel is None:
            # grpc.aio dials lazily and accepts any string, so validate
            # the target's SYNTAX eagerly. This mirrors the reference,
            # whose non-blocking grpc.Dial also only fails fast on
            # unparsable targets (gubernator.go:260-291): health reports
            # unhealthy for malformed peers, while well-formed but
            # unreachable ones surface at request time, as there.
            host, _, port = self.host.rpartition(":")
            if not host or not port.isdigit() or not (
                0 < int(port) < 65536
            ):
                raise ValueError(f"invalid peer address {self.host!r}")
            if not self.is_owner:
                self._open_channel()
        if self._flusher is None:
            self._flusher = asyncio.ensure_future(self._run())

    def _open_channel(self):
        """Dial the peer (lazily, as grpc.aio does); returns the stub."""
        import grpc

        from gubernator_tpu_torch.api.grpc_glue import PeersV1Stub

        self.channel = grpc.aio.insecure_channel(
            self.host,
            options=[
                # bound gRPC's reconnect backoff to the breaker cooldown:
                # during an outage the channel's redial backoff grows
                # (default cap 120s), so without this the half-open probe
                # after a peer RETURNS fails against a still-backed-off
                # channel and recovery stretches far past the breaker's
                # contract
                ("grpc.initial_reconnect_backoff_ms", 100),
                (
                    "grpc.max_reconnect_backoff_ms",
                    max(200, int(getattr(self.conf, "breaker_cooldown", 1.0) * 1000)),
                ),
            ],
        )
        self.stub = PeersV1Stub(self.channel)
        return self.stub

    def _get_stub(self):
        return self.stub if self.stub is not None else self._open_channel()

    async def close(self) -> None:
        # before cancelling the flusher: an enqueue AFTER its cancel-time
        # queue drain would land in a queue nothing reads — the flag makes
        # late forwards (a caller holding this peer across set_peers)
        # fail fast instead
        self._closed = True
        if self._flusher is not None:
            self._flusher.cancel()
            try:
                await self._flusher
            except asyncio.CancelledError:
                pass
            self._flusher = None
        if self.channel is not None:
            await self.channel.close()
            self.channel = None
            self.stub = None

    # -- forwarding ---------------------------------------------------------

    async def get_peer_rate_limit(self, r: RateLimitReq) -> RateLimitResp:
        """Forward one request; batches unless NO_BATCHING
        (reference peers.go:73-90)."""
        if r.behavior in (Behavior.BATCHING, Behavior.GLOBAL):
            resps = await self.get_peer_rate_limits_grouped([r])
            return resps[0]
        if self._closed:
            raise RuntimeError(f"peer client for '{self.host}' is closed")
        resp = await self.get_peer_rate_limits([r])
        return resp[0]

    async def get_peer_rate_limits_grouped(
        self, reqs: Sequence[RateLimitReq]
    ) -> List[RateLimitResp]:
        """Forward a whole group through the micro-batch flusher with
        ONE queue entry and ONE future (r7 owner batching). The group
        still coalesces with other callers' groups up to batch_limit
        — same wire behavior as per-item enqueueing, a fraction of the
        event-loop cost."""
        if self._closed:
            raise RuntimeError(f"peer client for '{self.host}' is closed")
        if not reqs:
            return []
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # the caller's trace context rides the queue entry (r16): the
        # flusher task that sends the batched RPC runs outside the
        # caller's context, so the traceparent must be captured HERE
        self._queue.put_nowait((list(reqs), fut, tracing.propagation_header()))
        return await fut

    async def get_peer_rate_limits(
        self,
        reqs: Sequence[RateLimitReq],
        traceparent: Optional[str] = None,
    ) -> List[RateLimitResp]:
        convert, peers_pb2 = _wire()
        pb_req = peers_pb2.GetPeerRateLimitsReq(
            requests=[convert.req_to_pb(r) for r in reqs]
        )
        timeout = self.conf.effective_peer_timeout()
        if traceparent is None:
            # direct callers (NO_BATCHING forwards, GLOBAL gossip) run
            # in their own context; batched callers pass the captured
            # header through _send_batch
            traceparent = tracing.propagation_header()
        # kwargs-style so the metadata key is ABSENT on untraced calls
        kw = (
            {"metadata": ((tracing.TRACEPARENT, traceparent),)}
            if traceparent
            else {}
        )

        async def call() -> List[RateLimitResp]:
            pb_resp = await self._get_stub().GetPeerRateLimits(
                pb_req, timeout=timeout or None, **kw
            )
            if len(pb_resp.rate_limits) != len(reqs):
                raise RuntimeError(
                    "peer responded with mismatched rate limit list size"
                )
            return [convert.resp_from_pb(p) for p in pb_resp.rate_limits]

        # a batch of pure peeks (hits all 0) is idempotent end to end;
        # anything carrying hits only retries transport-level failures
        # (is_retryable) so a slow peer is never double-counted
        return await self._call_resilient(
            call, idempotent=all(r.hits == 0 for r in reqs), timeout=timeout,
        )

    async def update_peer_globals(self, updates) -> None:
        """updates: sequence of (key, RateLimitResp). Installing a
        status replica is last-write-wins idempotent, so retries are
        always safe here."""
        convert, peers_pb2 = _wire()
        pb_req = peers_pb2.UpdatePeerGlobalsReq(
            globals=[
                peers_pb2.UpdatePeerGlobal(key=k, status=convert.resp_to_pb(s))
                for k, s in updates
            ]
        )
        timeout = self.conf.global_timeout
        # originating context rides along when the install happens
        # inside a traced request (r16); the background gossip loops
        # have no context and send bare metadata
        tp = tracing.propagation_header()
        kw = {"metadata": ((tracing.TRACEPARENT, tp),)} if tp else {}

        async def call() -> None:
            await self._get_stub().UpdatePeerGlobals(
                pb_req, timeout=timeout or None, **kw
            )

        await self._call_resilient(call, idempotent=True, timeout=timeout)

    async def replicate_buckets(self, snaps, owner: str) -> None:
        """Ship owned-bucket snapshots to this peer (the key's ring
        successor, a reconcile handback's returned owner, a rescale's new
        owner or a blue-green import door). `snaps`: a sequence of
        serve/replication.Snapshot. Installs are last-write-wins by
        (reset_time, snapshot_ms), so retries and duplicate deliveries
        are always safe."""
        _convert, peers_pb2 = _wire()
        pb_req = peers_pb2.ReplicateBucketsReq(
            owner=owner,
            buckets=[
                peers_pb2.BucketSnapshot(
                    key=s.key,
                    algorithm=s.algorithm,
                    limit=s.limit,
                    duration=s.duration,
                    remaining=s.remaining,
                    reset_time=s.reset_time,
                    status=s.status,
                    snapshot_ms=s.snapshot_ms,
                )
                for s in snaps
            ],
        )
        timeout = self.conf.global_timeout
        tp = tracing.propagation_header()
        kw = {"metadata": ((tracing.TRACEPARENT, tp),)} if tp else {}

        async def call() -> None:
            await self._get_stub().ReplicateBuckets(
                pb_req, timeout=timeout or None, **kw
            )

        await self._call_resilient(call, idempotent=True, timeout=timeout)

    # -- resilience envelope (r8) -------------------------------------------

    async def _call_resilient(self, do_call, idempotent: bool, timeout: float):
        """Deadline + circuit breaker + bounded retry around one peer
        RPC. The deadline wraps fault injection AND the RPC, so an
        injected hang (GUBER_FAULT_SPEC peer_rpc:hang) is bounded
        exactly like a wedged peer. Retries use exponential backoff
        with FULL jitter; only is_retryable failures re-send."""
        c = self.conf
        attempt = 0
        while True:
            b = self.breaker
            token = b.acquire() if b is not None else None
            if b is not None and not token:
                raise BreakerOpenError(
                    f"peer '{self.host}' circuit open (failing fast)"
                )
            try:
                result = await asyncio.wait_for(
                    self._guarded(do_call), timeout or None
                )
            except asyncio.CancelledError:
                # teardown, not peer health: release a half-open probe
                # slot without counting an outcome
                if b is not None:
                    b.record_cancel(token)
                raise
            except Exception as e:
                if b is not None:
                    b.record_failure(token)
                retries = getattr(c, "peer_retries", 0)
                if (
                    attempt < retries
                    and is_retryable(e, idempotent)
                    # when THIS failure tripped the breaker, don't sleep
                    # a backoff only to raise BreakerOpenError on
                    # re-acquire: fail fast with the root-cause error
                    and (b is None or b.state != BREAKER_OPEN)
                ):
                    attempt += 1
                    try:
                        metrics.PEER_RPC_RETRIES.labels(peer=self.host).inc()
                    except Exception:  # pragma: no cover - defensive
                        pass
                    await asyncio.sleep(
                        random.uniform(
                            0.0,
                            min(
                                c.peer_backoff_max,
                                c.peer_backoff * (2 ** (attempt - 1)),
                            ),
                        )
                    )
                    continue
                raise
            if b is not None:
                b.record_success(token)
            return result

    async def _guarded(self, do_call):
        if FAULTS.enabled:
            await FAULTS.inject("peer_rpc", peer=self.host)
        return await do_call()

    # -- micro-batch flusher ------------------------------------------------

    async def _run(self) -> None:
        """Coalesce queued requests; flush at batch_limit or after
        batch_wait from the first enqueue (reference peers.go:143-172).
        Everything already enqueued is drained without waiting, so batches
        grow with in-flight RPC load while a lone request only waits the
        configured window (batch_wait=0 disables even that)."""
        while True:
            batch: List[Tuple[List[RateLimitReq], asyncio.Future, Optional[str]]] = []
            try:
                await collect_batch(
                    self._queue,
                    self.conf.batch_limit,
                    self.conf.batch_wait,
                    batch,
                    weight=lambda g: max(1, len(g[0])),
                    carry=self._carry,
                )
                await self._send_batch(batch)
            except asyncio.CancelledError:
                # close() (e.g. set_peers replacing this peer) mid-collect
                # or mid-send: every caller parked on a queued future gets
                # an error, never a hang
                exc = RuntimeError(f"peer client for '{self.host}' closed mid-batch")
                for _, fut, _tp in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                for _, fut, _tp in self._carry:
                    if not fut.done():
                        fut.set_exception(exc)
                self._carry.clear()
                while True:
                    try:
                        _, fut, _tp = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if not fut.done():
                        fut.set_exception(exc)
                raise

    async def _send_batch(self, batch) -> None:
        # groups flatten into one peer RPC; responses slice back per
        # group (reference peers.go:143-172, group-granular here)
        reqs = [r for g, _, _tp in batch for r in g]
        # one traceparent per RPC: micro-batching can coalesce groups
        # from different traced callers, so the FIRST traced group's
        # context represents the wire hop
        tp = next((g[2] for g in batch if g[2]), None)
        try:
            resps = await self.get_peer_rate_limits(reqs, traceparent=tp)
        except Exception as e:  # entire batch failed (peers.go:186-192)
            for _, fut, _tp in batch:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"while fetching from peer - '{e}'")
                    )
            return
        k = 0
        for g, fut, _tp in batch:
            span = resps[k : k + len(g)]
            k += len(g)
            if not fut.done():
                fut.set_result(span)


class ConsistentHashPicker:
    """Ring-placement-compatible peer picker (reference hash.go)."""

    def __init__(self, hash_fn=ring_hash):
        self._hash = hash_fn
        self._keys: List[int] = []
        self._by_point: Dict[int, PeerClient] = {}
        self._by_host: Dict[str, PeerClient] = {}

    def new(self) -> "ConsistentHashPicker":
        return ConsistentHashPicker(self._hash)

    def add(self, peer: PeerClient) -> None:
        point = self._hash(peer.host)
        existing = self._by_point.get(point)
        if existing is not None and existing.host != peer.host:
            # two addresses on one crc32 point would silently split
            # ownership between pickers: refuse loudly (set_peers
            # surfaces it through health)
            raise ValueError(
                f"ring point collision: '{peer.host}' and "
                f"'{existing.host}' both hash to {point:#x}; rename one "
                f"peer address (placement would silently diverge "
                f"between pickers)"
            )
        if existing is None:
            bisect.insort(self._keys, point)
        self._by_point[point] = peer
        self._by_host[peer.host] = peer

    def size(self) -> int:
        return len(self._keys)

    def peers(self) -> List[PeerClient]:
        return list(self._by_host.values())

    def get_peer_by_host(self, host: str) -> Optional[PeerClient]:
        return self._by_host.get(host)

    def get(self, key: str) -> PeerClient:
        """Successor peer on the ring for this key's point, wrapping
        (reference hash.go:80-96)."""
        if not self._keys:
            raise RuntimeError("unable to pick a peer; pool is empty")
        point = self._hash(key)
        i = bisect.bisect_left(self._keys, point)
        if i == len(self._keys):
            i = 0
        return self._by_point[self._keys[i]]

    def get_successor(self, key: str) -> Optional[PeerClient]:
        """The peer that would own `key` if its current owner left the
        ring: the next ring point after the key's, skipping the owner's
        own points (wrapping like get()). Both the replication target
        (serve/replication.py) and the takeover route when the owner's
        breaker opens. None when the ring has fewer than two hosts."""
        if not self._keys:
            return None
        point = self._hash(key)
        i = bisect.bisect_left(self._keys, point)
        if i == len(self._keys):
            i = 0
        owner = self._by_point[self._keys[i]]
        n = len(self._keys)
        for step in range(1, n):
            peer = self._by_point[self._keys[(i + step) % n]]
            if peer.host != owner.host:
                return peer
        return None

    def ownership_diff(
        self, new: "ConsistentHashPicker", keys: Sequence[str]
    ) -> Dict[str, Tuple["PeerClient", List[str]]]:
        """Keys THIS ring routes to this node (is_owner) that `new` routes
        to a DIFFERENT host, grouped by their new owner:
        {new_owner_host: (new_owner_client, [keys])}: the planned-handoff
        work list of a ring change (serve/rescale.py), called on the OLD
        picker. Keys the old ring did not route here, and keys still owned
        here under `new`, contribute nothing; an empty ring on either side
        diffs to nothing."""
        out: Dict[str, Tuple[PeerClient, List[str]]] = {}
        if not self._keys or not new._keys:
            return out
        for key in keys:
            if not self.get(key).is_owner:
                continue
            owner = new.get(key)
            if owner.is_owner:
                continue
            entry = out.get(owner.host)
            if entry is None:
                out[owner.host] = (owner, [key])
            else:
                entry[1].append(key)
        return out

    def self_owned_mask(self, keys: Sequence[str]):
        """bool[len(keys)]: the key's ring successor is this server
        itself (is_owner). The ownership screen of the edge bridge's
        string->array fold (serve/edge_bridge.py): one hash call per key
        and a single searchsorted against the ring; placement is get()'s
        (bisect_left == searchsorted side='left', wrapping to 0)."""
        import numpy as np

        if not self._keys:
            raise RuntimeError("unable to pick a peer; pool is empty")
        pts = np.fromiter(
            (self._hash(k) for k in keys), dtype=np.uint64, count=len(keys)
        )
        ring = np.asarray(self._keys, dtype=np.uint64)
        idx = np.searchsorted(ring, pts, side="left")
        idx[idx == len(ring)] = 0
        own = np.fromiter(
            (self._by_point[p].is_owner for p in self._keys),
            dtype=bool,
            count=len(self._keys),
        )
        return own[idx]
