"""GLOBAL behavior gossip: async hit forwarding + owner status broadcasts.

The port's copy of gubernator_tpu/serve/global_mgr.py with its imports
rewritten. Hit flushes and status broadcasts reach the other ring members
over PeersV1 (serve/peers.PeerClient); self-destined hits apply locally
(on a MeshBackend in one owner-charge + replica-install step). No peer is
mesh_local (the flag marks the multi-host mesh's lockstep followers,
which the port does not carry yet), so the mesh-local install path stays
idle. File references below are the reference package's.

The host-level twin of the reference's globalManager (reference
global.go:29-232), on asyncio instead of goroutines:

- Non-owners answer GLOBAL requests from their local replica and queue the
  hits here; hits aggregate per key and flush to owning peers every
  `global_sync_wait` or at `global_batch_limit` (global.go:72-111).
- Owners queue every GLOBAL key they decide; the broadcast loop dedups,
  peeks current status (a zero-hit decide), and pushes UpdatePeerGlobals to
  every other peer (global.go:158-232).

When the peers are TPU shards of one mesh rather than remote hosts, the
same aggregate->apply->broadcast cycle runs as collectives instead
(parallel/sharded.py sync_globals); this module is the DCN/gRPC edge of
the gossip.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import replace
from typing import Dict, Optional

from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.serve.config import BehaviorConfig
from gubernator_tpu_torch.serve.metrics import (
    GLOBAL_ASYNC_DURATIONS,
    GLOBAL_BACKLOG_DROPPED,
    GLOBAL_BROADCAST_DURATIONS,
    GLOBAL_FLUSH_BYTES,
    GLOBAL_TASK_RESTARTS,
)

log = logging.getLogger("gubernator_tpu_torch.global")

#: supervision backoff bounds for a crashing gossip loop: restart fast
#: after a one-off (a dead loop silently stops ALL GLOBAL gossip), back
#: off exponentially while the crash repeats, reset once a run survives
#: SUPERVISE_RESET_S
SUPERVISE_BACKOFF_S = 0.05
SUPERVISE_BACKOFF_MAX_S = 5.0
SUPERVISE_RESET_S = 60.0

#: concurrent per-peer sends per gossip flush (r9): sequential awaits
#: made flush latency O(#peers x RTT) — at 20 peers x 5ms that's 100ms
#: of serialized wall time per broadcast, directly in BASELINE config
#: 3's p99 path. Bounded so a large fleet can't open hundreds of
#: simultaneous RPCs from one flush.
SEND_FANOUT = 16


async def supervise(name: str, loop_factory) -> None:
    """Keep a gossip-style background loop alive: an unexpected death
    restarts it with bounded exponential backoff instead of only
    logging (the pre-r8 behavior left GLOBAL gossip silently dead for
    the rest of the process). A loop that ran healthily for longer than
    SUPERVISE_RESET_S before dying restarts at the BASE backoff, not
    the escalated one. Restarts are counted in
    global_task_restarts_total{task}. Shared by GlobalManager and
    ReplicationManager (serve/replication.py)."""
    backoff = SUPERVISE_BACKOFF_S
    while True:
        started = time.monotonic()
        try:
            await loop_factory()
            return  # loops are infinite; a clean return means done
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if time.monotonic() - started > SUPERVISE_RESET_S:
                backoff = SUPERVISE_BACKOFF_S
            log.error(
                "%s loop died: %r; restarting in %.2fs",
                name, e, backoff, exc_info=e,
            )
            try:
                GLOBAL_TASK_RESTARTS.labels(task=name).inc()
            except Exception:  # pragma: no cover - defensive
                pass
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, SUPERVISE_BACKOFF_MAX_S)


class GlobalManager:
    def __init__(self, conf: BehaviorConfig, instance):
        self.conf = conf
        self.instance = instance
        self._hits: Dict[str, RateLimitReq] = {}
        self._updates: Dict[str, RateLimitReq] = {}
        self._hits_event = asyncio.Event()
        self._updates_event = asyncio.Event()
        self._tasks = []
        self._dropped = {"hits": 0, "updates": 0}

    def start(self) -> None:
        if not self._tasks:
            self._tasks = [
                asyncio.ensure_future(
                    self._supervise("async_hits", self._run_async_hits)
                ),
                asyncio.ensure_future(
                    self._supervise("broadcasts", self._run_broadcasts)
                ),
            ]

    async def _supervise(self, name: str, loop_factory) -> None:
        # the plain task name keeps the metric label stable
        # (global_task_restarts_total{task="async_hits"|"broadcasts"})
        await supervise(name, loop_factory)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []

    async def drain(self) -> None:
        """Graceful-drain flush: push whatever is aggregated NOW instead
        of waiting out the sync window — pending non-owner hits reach
        their owners and owned-key statuses broadcast before shutdown.
        Send errors are already logged per peer by the senders."""
        hits, self._hits = self._hits, {}
        self._hits_event.clear()
        if hits:
            await self._send_hits(hits)
        updates, self._updates = self._updates, {}
        self._updates_event.clear()
        if updates:
            await self._update_peers(updates)

    def backlog_sizes(self) -> Dict[str, int]:
        """Standing aggregation occupancy for the scrape-time
        global_backlog_entries gauge (r16): distinct keys waiting in
        each queue, against the GUBER_GLOBAL_BACKLOG bound."""
        return {"hits": len(self._hits), "updates": len(self._updates)}

    # -- queue entry points (non-blocking, called on the serving loop) ------

    def queue_hit(self, r: RateLimitReq) -> None:
        """Aggregate a non-owner hit for async forwarding
        (global.go:62-64,78-86). Bounded: an unreachable owner must not
        grow the backlog for the whole outage — past
        GUBER_GLOBAL_BACKLOG distinct keys, NEW keys are dropped (and
        counted); keys already aggregating keep accumulating for free."""
        key = r.hash_key()
        cur = self._hits.get(key)
        if cur is not None:
            cur.hits += r.hits
        elif len(self._hits) >= self.conf.global_backlog:
            self._drop("hits")
            return
        else:
            self._hits[key] = replace(r)
        self._hits_event.set()

    def queue_update(self, r: RateLimitReq) -> None:
        """Mark an owned GLOBAL key for status broadcast
        (global.go:66-68,164-165). Bounded like queue_hit."""
        key = r.hash_key()
        if key not in self._updates and (
            len(self._updates) >= self.conf.global_backlog
        ):
            self._drop("updates")
            return
        self._updates[key] = replace(r)
        self._updates_event.set()

    def _drop(self, queue: str) -> None:
        self._dropped[queue] += 1
        n = self._dropped[queue]
        if n & (n - 1) == 0:  # log at powers of two, not per drop
            log.warning(
                "GLOBAL %s backlog full (GUBER_GLOBAL_BACKLOG=%d): "
                "%d new key(s) dropped so far this process",
                queue, self.conf.global_backlog, n,
            )
        try:
            GLOBAL_BACKLOG_DROPPED.labels(queue=queue).inc()
        except Exception:  # pragma: no cover - defensive
            pass

    # -- loops --------------------------------------------------------------

    async def _run_async_hits(self) -> None:
        while True:
            await self._hits_event.wait()
            # batch-limit flush happens immediately; otherwise wait out the
            # sync window to coalesce (global.go:88-104)
            if len(self._hits) < self.conf.global_batch_limit:
                await asyncio.sleep(self.conf.global_sync_wait)
            hits, self._hits = self._hits, {}
            self._hits_event.clear()
            if hits:
                await self._send_hits(hits)

    @staticmethod
    def _payload_bytes(reqs) -> int:
        """Approximate wire payload of a hit chunk (name + unique-key
        UTF-8 bytes plus ~40B of fixed int fields per request) — cheap
        accounting for global_flush_bytes_total. The metric's point is
        the rpc/mesh SPLIT, not exact protobuf framing."""
        return sum(len(r.name) + len(r.unique_key) + 40 for r in reqs)

    async def _apply_local(self, reqs) -> None:
        """Self-destined flush chunk (r20): this node IS the ring owner
        of these keys, so the 'send' is an in-mesh apply — one psum
        collective charging each key's owner SHARD
        (instance.apply_global_hits_local) — instead of a loopback
        gossip RPC. Backends without the collective surface fall back
        to the plain local decide path inside the instance hook. Errors
        are logged, not raised: a failed local apply must not kill the
        flush loop any more than a failed peer RPC does."""
        try:
            apply = getattr(self.instance, "apply_global_hits_local", None)
            if apply is not None:
                await apply(reqs)
            else:
                await self.instance.decide_local(
                    reqs, [False] * len(reqs)
                )
        except Exception as e:
            log.error("error applying mesh-local global hits: %s", e)

    async def _send_hits(self, hits: Dict[str, RateLimitReq]) -> None:
        """Per-destination flush of aggregated hits (global.go:115-155 +
        r20 mesh-native GLOBAL): keys owned by an off-mesh ring peer
        forward over gossip RPC; keys owned by THIS node (the ring
        handed them back, or the flush raced a ring change) short-
        circuit through the local apply path — one in-mesh collective
        instead of a loopback RPC. GUBER_GLOBAL_MESH=0 restores the
        all-RPC fan-out. The r16 trace span carries the per-path hop
        counts so the collective win is visible per flush, not just as
        aggregate throughput."""
        start = time.monotonic()
        tracer = getattr(self.instance, "tracer", None)
        trace = tracer.begin("global_flush") if tracer is not None else None
        by_peer: Dict[str, list] = {}
        clients = {}
        local: list = []
        use_mesh = getattr(self.conf, "global_mesh", True)
        for key, r in hits.items():
            try:
                peer = self.instance.get_peer(key)
            except Exception as e:
                log.error("while getting peer for hash key '%s': %s", key, e)
                continue
            if use_mesh and getattr(peer, "is_owner", False):
                local.append(r)
                continue
            by_peer.setdefault(peer.host, []).append(r)
            clients[peer.host] = peer
        lim = self.conf.global_batch_limit
        hops_mesh = 0
        if local:
            # one collective per chunk; a steady-state flush fits one
            for i in range(0, len(local), lim):
                hops_mesh += 1
                await self._apply_local(local[i : i + lim])
            try:
                GLOBAL_FLUSH_BYTES.labels(path="mesh").inc(
                    self._payload_bytes(local)
                )
            except Exception:  # pragma: no cover - defensive
                pass
        # fan the per-peer sends out concurrently (bounded): each key
        # appears in exactly one aggregated chunk, so cross-chunk order
        # is immaterial and flush latency becomes ~one RTT instead of
        # O(#peers x RTT). Errors stay logged per peer, per chunk.
        sem = asyncio.Semaphore(SEND_FANOUT)

        async def send(host, chunk):
            async with sem:
                try:
                    await asyncio.wait_for(
                        clients[host].get_peer_rate_limits(chunk),
                        timeout=self.conf.global_timeout,
                    )
                except Exception as e:
                    log.error(
                        "error sending global hits to '%s': %s", host, e
                    )

        sends = [
            send(host, reqs[i : i + lim])
            for host, reqs in by_peer.items()
            # a flush can have aggregated more keys than one peer RPC
            # may carry (the owner hard-rejects >MAX_BATCH_SIZE); chunk
            for i in range(0, len(reqs), lim)
        ]
        if sends:
            await asyncio.gather(*sends)
            try:
                GLOBAL_FLUSH_BYTES.labels(path="rpc").inc(
                    sum(self._payload_bytes(c) for c in by_peer.values())
                )
            except Exception:  # pragma: no cover - defensive
                pass
        if trace is not None:
            # hop-count evidence for the r20 collective path: a mesh-
            # local flush is hops_mesh=1 regardless of #peers, where
            # the RPC path pays one hop per (peer, chunk)
            trace.add_span(
                "global_flush_hits",
                start=start,
                hops_rpc=len(sends),
                hops_mesh=hops_mesh,
                keys_mesh=len(local),
                keys_rpc=sum(len(v) for v in by_peer.values()),
                peers_rpc=len(by_peer),
            )
            tracer.finish(trace)
        GLOBAL_ASYNC_DURATIONS.observe(time.monotonic() - start)

    async def _run_broadcasts(self) -> None:
        while True:
            await self._updates_event.wait()
            if len(self._updates) < self.conf.global_batch_limit:
                await asyncio.sleep(self.conf.global_sync_wait)
            updates, self._updates = self._updates, {}
            self._updates_event.clear()
            if updates:
                await self._update_peers(updates)

    @staticmethod
    def _update_bytes(updates) -> int:
        """Approximate wire payload of an update chunk (key UTF-8 bytes
        plus ~48B of status fields per entry) — same cheap accounting
        stance as _payload_bytes: the metric's point is the rpc/mesh
        split, not protobuf framing."""
        return sum(len(k) + 48 for k, _ in updates)

    async def _install_local(self, updates) -> None:
        """Mesh-local broadcast chunk (r21): these replicas live in THIS
        node's mesh (lockstep followers / a co-scheduled server sharing
        the device store), so ONE local install covers every mesh-local
        peer — the same replica-install path the gossip door runs on
        receive (instance.update_peer_globals), without the loop of
        per-peer RPCs. Errors are logged, not raised, mirroring
        _apply_local: a failed install must not kill the broadcast
        loop."""
        try:
            install = getattr(
                self.instance, "update_peer_globals_local", None
            ) or self.instance.update_peer_globals
            await install(updates)
        except Exception as e:
            log.error("error installing mesh-local global updates: %s", e)

    async def _update_peers(self, updates: Dict[str, RateLimitReq]) -> None:
        """Peek authoritative status for each updated key and broadcast to
        all other peers (global.go:193-232), split per destination like
        _send_hits (r20 -> r21): peers marked mesh_local receive the
        whole batch through ONE local mesh install regardless of their
        count, off-mesh peers keep the bounded-concurrency RPC fan-out.
        GUBER_GLOBAL_MESH=0 restores the all-RPC broadcast."""
        start = time.monotonic()
        tracer = getattr(self.instance, "tracer", None)
        trace = (
            tracer.begin("global_broadcast") if tracer is not None else None
        )
        globals_batch = []
        peek_reqs = []
        keys = []
        for key, r in updates.items():
            peek = replace(r, hits=0, behavior=Behavior.BATCHING)
            peek_reqs.append(peek)
            keys.append(key)
        try:
            statuses = await self.instance.decide_local(
                peek_reqs, gnp=[False] * len(peek_reqs)
            )
            globals_batch = list(zip(keys, statuses))
        except Exception as e:
            log.error("while peeking global statuses: %s", e)

        hops_mesh = 0
        sends = []
        rpc_peers = []
        mesh_peers = 0
        if globals_batch:
            use_mesh = getattr(self.conf, "global_mesh", True)
            for peer in self.instance.peer_list():
                if peer.is_owner:  # never broadcast to ourselves
                    continue
                if use_mesh and getattr(peer, "mesh_local", False):
                    mesh_peers += 1
                else:
                    rpc_peers.append(peer)
            lim = self.conf.global_batch_limit
            if mesh_peers:
                # one install per chunk covers EVERY mesh-local peer:
                # the replicas share this node's device store
                for i in range(0, len(globals_batch), lim):
                    hops_mesh += 1
                    await self._install_local(globals_batch[i : i + lim])
                try:
                    GLOBAL_FLUSH_BYTES.labels(path="mesh").inc(
                        self._update_bytes(globals_batch)
                    )
                except Exception:  # pragma: no cover - defensive
                    pass
            # bounded concurrent fan-out (r9): the broadcast used to
            # await each peer in turn, making gossip propagation — and
            # with it the replicas' staleness window — scale linearly
            # with fleet size. Installs are idempotent last-writer-wins
            # upserts, so concurrent delivery is safe; per-peer error
            # logging is preserved inside each send.
            sem = asyncio.Semaphore(SEND_FANOUT)

            async def send(peer, chunk):
                async with sem:
                    try:
                        await asyncio.wait_for(
                            peer.update_peer_globals(chunk),
                            timeout=self.conf.global_timeout,
                        )
                    except Exception as e:
                        log.error(
                            "error sending global updates to '%s': %s",
                            peer.host,
                            e,
                        )

            sends = [
                send(peer, globals_batch[i : i + lim])
                for peer in rpc_peers
                for i in range(0, len(globals_batch), lim)
            ]
            if sends:
                await asyncio.gather(*sends)
                try:
                    GLOBAL_FLUSH_BYTES.labels(path="rpc").inc(
                        self._update_bytes(globals_batch) * len(rpc_peers)
                    )
                except Exception:  # pragma: no cover - defensive
                    pass
        if trace is not None:
            # hop-count evidence mirroring global_flush_hits: the whole
            # mesh-local replica SET costs hops_mesh=1 per chunk, while
            # the RPC path pays one hop per (peer, chunk)
            trace.add_span(
                "global_flush_updates",
                start=start,
                hops_rpc=len(sends),
                hops_mesh=hops_mesh,
                keys_mesh=len(globals_batch) if hops_mesh else 0,
                keys_rpc=len(globals_batch) * len(rpc_peers),
                peers_mesh=mesh_peers,
                peers_rpc=len(rpc_peers),
            )
            tracer.finish(trace)
        GLOBAL_BROADCAST_DURATIONS.observe(time.monotonic() - start)
