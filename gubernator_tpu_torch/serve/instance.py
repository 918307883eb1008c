"""The serving instance: validation, routing, the shed screen and the
local decide (the port of gubernator_tpu/serve/instance.py).

The engine-room of one server process, mirroring the reference
Instance's contract (reference gubernator.go:41-322) with an asyncio +
batched-device execution model:

- get_rate_limits validates each entry, routes it on the ring, screens
  the over-limit shed cache (serve/shedcache.py: frozen token-bucket
  refusals answer host-side, before the batcher), and coalesces the rest
  into device batches through the DeviceBatcher; owned GLOBAL keys queue
  their status broadcast (GlobalManager). Responses reassemble in
  request order (gubernator.go:75-169).
- update_peer_globals installs owner-broadcast GLOBAL replicas
  (gubernator.go:199-207), and apply_global_hits_local charges GLOBAL
  hits flushed to this node.
- set_peers rebuilds the picker and recomputes health
  (gubernator.go:254-292); health_check merges in breaker state.

Not ported yet, and refused loudly rather than ignored: forwarding to
other nodes (set_peers takes only a ring whose one member is this node;
the PeersV1 door, the owner side of GetPeerRateLimits and degraded mode
come with the doors' slice), bucket replication, ring rescale and
checkpoint/restore (a config that turns one on raises at construction),
and quota chains (a chained item gets a per-item error).
Comments name the reference's modules and files.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

from gubernator_tpu_torch.api.types import (
    Behavior,
    HealthCheckResp,
    PeerInfo,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.core.hashing import slot_hash_batch
from gubernator_tpu_torch.core.sketches import TrafficStats
from gubernator_tpu_torch.serve import tracing
from gubernator_tpu_torch.serve.batcher import DeviceBatcher
from gubernator_tpu_torch.serve.breaker import OPEN as BREAKER_OPEN
from gubernator_tpu_torch.serve.config import MAX_BATCH_SIZE, ServerConfig
from gubernator_tpu_torch.serve.global_mgr import GlobalManager
from gubernator_tpu_torch.serve.peers import (
    FORWARDING_NOT_PORTED,
    ConsistentHashPicker,
    PeerClient,
)
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.instance")

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"


class BatchTooLargeError(ValueError):
    pass


#: the per-item error of a chained request: quota chains are not ported
CHAINS_NOT_PORTED = "quota chains are not ported to gubernator_tpu_torch yet"


class Instance:
    def __init__(self, conf: ServerConfig, backend):
        # bucket replication, ring rescale and checkpoint/restore are
        # not ported yet: a config that asks for one is refused here,
        # never silently ignored
        asked = [
            name
            for name, on in (
                ("GUBER_REPLICATION (serve/replication.py)",
                 getattr(conf, "replication", False)),
                ("GUBER_RESCALE (serve/rescale.py)",
                 getattr(conf, "rescale", False)),
                ("GUBER_CHECKPOINT_DIR / GUBER_CHECKPOINT_EXPORT_PEERS "
                 "(serve/checkpoint.py)",
                 bool(getattr(conf, "checkpoint_dir", ""))
                 or bool(getattr(conf, "checkpoint_export_peers", ()))),
            )
            if on
        ]
        if asked:
            raise ValueError(
                "not ported to gubernator_tpu_torch yet: "
                + "; ".join(asked)
            )
        self.conf = conf
        self.backend = backend
        self.batcher = DeviceBatcher(
            backend,
            batch_wait=conf.device_batch_wait,
            batch_limit=conf.device_batch_limit,
            fetch_depth=conf.device_fetch_depth,
            deep_batch=conf.device_deep_batch,
            prep_at_arrival=conf.prep_at_arrival,
            prep_threads=conf.prep_threads,
        )
        self.global_mgr = GlobalManager(conf.behaviors, self)
        # distributed tracing (r16, serve/tracing.py): per-instance so
        # an in-process LocalCluster keeps one flight recorder per
        # node. Disabled by default (GUBER_TRACE_SAMPLE=0,
        # GUBER_TRACE_SLOW_MS=0) — every instrumented site then pays
        # one branch and nothing allocates.
        self.tracer = tracing.Tracer(
            sample=getattr(conf, "trace_sample", 0.0),
            slow_ms=getattr(conf, "trace_slow_ms", 0.0),
            capacity=getattr(conf, "trace_buffer", 256),
        )
        self.picker = ConsistentHashPicker()
        self.health = HealthCheckResp(status=HEALTHY, peer_count=0)
        self.traffic = TrafficStats()
        # over-limit shed cache (r10, serve/shedcache.py): host-side
        # answers for frozen token-bucket refusals, consulted before
        # anything enqueues toward the device. Shared with the edge
        # bridge, which screens its array frames against the same
        # cache. None = disabled (GUBER_SHED_CACHE=0 or a zero bound).
        shed_keys = getattr(conf, "shed_cache_keys", 0)
        if getattr(conf, "shed_cache", False) and shed_keys > 0:
            from gubernator_tpu_torch.serve.shedcache import ShedCache

            self.shed = ShedCache(
                shed_keys,
                generation_fn=getattr(backend, "shed_generation", None),
            )
        else:
            self.shed = None
        # sketch-tier promoter (r13, serve/promoter.py): streaming
        # SpaceSaving top-K over dispatched key hashes; hot sketch-tier
        # keys migrate into exact buckets on a flush-tick cadence, and
        # over-limit candidates seed the shed cache. Only constructed
        # when the backend actually carries the count-min tier.
        if getattr(conf, "sketch", False) and getattr(
            backend, "sketch_enabled", False
        ):
            from gubernator_tpu_torch.serve.promoter import SketchPromoter

            self.promoter = SketchPromoter(conf, self)
        else:
            self.promoter = None

    def start(self) -> None:
        self.batcher.start()
        self.global_mgr.start()
        if self.promoter is not None:
            self.promoter.start()

    async def stop(self) -> None:
        if self.promoter is not None:
            await self.promoter.stop()
        await self.global_mgr.stop()
        await self.batcher.stop()
        for peer in self.picker.peers():
            await peer.close()

    # -- public API (gubernator.go:75-169) ----------------------------------

    async def get_rate_limits(
        self,
        reqs: Sequence[RateLimitReq],
        stage_frame: bool = False,
    ) -> List[RateLimitResp]:
        """`stage_frame=True` (edge bridge string path only) marks the
        local device group as one edge frame's work for the per-frame
        stage clock; direct gRPC/HTTP/peer callers stay unattributed so
        frame coverage keeps its denominator (serve/stages.py)."""
        if len(reqs) > MAX_BATCH_SIZE:
            raise BatchTooLargeError(
                f"Requests.RateLimits list too large; max size is "
                f"'{MAX_BATCH_SIZE}'"
            )

        out: List[Optional[RateLimitResp]] = [None] * len(reqs)
        local: List[Tuple[int, RateLimitReq]] = []
        t_route0 = time.monotonic()

        # validation pass first so the whole batch's fingerprints hash
        # in one call — the routing pass below consults the over-limit
        # shed cache with them, and the response hook uses them to
        # populate it (fps: out-index -> fingerprint)
        valid: List[Tuple[int, RateLimitReq, str]] = []
        for i, r in enumerate(reqs):
            if not r.unique_key:
                out[i] = RateLimitResp(
                    error="field 'unique_key' cannot be empty"
                )
                continue
            if not r.name:
                out[i] = RateLimitResp(
                    error="field 'namespace' cannot be empty"
                )
                continue
            if r.chain:
                out[i] = RateLimitResp(error=CHAINS_NOT_PORTED)
                continue
            valid.append((i, r, r.hash_key()))

        hashes = (
            slot_hash_batch([k for _, _, k in valid]) if valid else None
        )
        shed = self.shed
        if shed is not None:
            shed.refresh_generation()
        fps = {}

        # the ring holds this node alone (set_peers), so every routed key
        # is owned here: the reference's non-owner branches (GLOBAL
        # replica answers, forwards to the owner) come with forwarding
        for j, (i, r, key) in enumerate(valid):
            h = int(hashes[j])
            fps[i] = h
            try:
                self.get_peer(key)
            except Exception as e:
                out[i] = RateLimitResp(
                    error=(
                        f"while finding peer that owns rate limit "
                        f"'{key}' - '{e}'"
                    )
                )
                continue
            # over-limit shed screen (serve/shedcache.py): a cached
            # frozen refusal answers here, with no batcher trip. An
            # owned GLOBAL key still queues its status broadcast, as the
            # device path would (the broadcast loop's peeks carry hits=0
            # and therefore always bypass the shed).
            verdict = (
                shed.lookup_resp(h, r) if shed is not None else None
            )
            if verdict is not None:
                if r.behavior == Behavior.GLOBAL:
                    self.global_mgr.queue_update(r)
                out[i] = verdict
                continue
            local.append((i, r))

        if valid:
            self.traffic.observe([k for _, _, k in valid], hashes)
        # instance-side routing overhead (validation + ring lookups +
        # shed screen + sketches), attributed apart from the batcher's
        # queue/device stages
        STAGES.add("instance_route", time.monotonic() - t_route0)

        if local:
            local_reqs = [r for _, r in local]
            try:
                resps = await self.decide_local(
                    local_reqs, [False] * len(local), frame=stage_frame
                )
                for (i, _), resp in zip(local, resps):
                    out[i] = resp
                if shed is not None:
                    shed.observe_resps(
                        [fps[i] for i, _ in local], local_reqs, resps
                    )
            except Exception as e:
                for i, r in local:
                    out[i] = RateLimitResp(
                        error=(
                            f"while applying rate limit for "
                            f"'{r.hash_key()}' - '{e}'"
                        )
                    )
        return [r if r is not None else RateLimitResp() for r in out]

    async def decide_local(
        self,
        reqs: Sequence[RateLimitReq],
        gnp: Sequence[bool],
        frame: bool = False,
    ) -> List[RateLimitResp]:
        """Run requests through the device batcher; owned GLOBAL keys are
        queued for status broadcast (gubernator.go:240-242)."""
        for r, is_gnp in zip(reqs, gnp):
            if r.behavior == Behavior.GLOBAL and not is_gnp:
                self.global_mgr.queue_update(r)
        return await self.batcher.decide(reqs, gnp, frame=frame)

    async def apply_global_hits_local(
        self, reqs: Sequence[RateLimitReq]
    ) -> None:
        """Mesh-native GLOBAL flush target (r20): apply aggregated gossip
        hits for keys THIS node owns in one in-mesh collective
        (backend.apply_global_hits_reqs on the serialized submit thread),
        then queue each key for the owner status broadcast — the same
        post-charge gossip a remote owner's decide_local would have
        queued, so off-mesh ring peers still learn the new remaining.
        Backends without the collective surface fall back to the plain
        local decide path."""
        fn = getattr(self.backend, "apply_global_hits_reqs", None)
        if fn is None:
            await self.decide_local(reqs, [False] * len(reqs))
            return
        await self.batcher.run_serialized(fn, list(reqs))
        for r in reqs:
            self.global_mgr.queue_update(r)

    # -- GLOBAL replica installs -------------------------------------------

    async def update_peer_globals(
        self, updates: Sequence[Tuple[str, RateLimitResp]]
    ) -> None:
        if self.shed is None or not updates:
            await self.batcher.update_globals(list(updates))
            return
        # device-authoritative invalidation: an owner broadcast
        # replaced these keys' replicas, so any cached verdict for
        # them is no longer provably current (the next hit reads the
        # fresh replica and repopulates). Purge BEFORE the install
        # (stop shedding from the doomed entries immediately) and
        # AGAIN after it: an in-flight decide that resolved during the
        # install await could otherwise re-insert the PRE-install
        # verdict just after the first purge and shadow the fresh
        # replica until its old reset_time.
        hashes = slot_hash_batch([k for k, _ in updates])
        self.shed.purge(hashes)
        try:
            await self.batcher.update_globals(list(updates))
        finally:
            self.shed.purge(hashes)

    def health_check(self) -> HealthCheckResp:
        """Membership health (set_peers) merged with live breaker state:
        a peer whose circuit is open is a dialable-but-dead peer, the
        exact condition the reference's health contract (peer
        dialability) cannot see. Reported unhealthy so orchestration
        rotates traffic away while the breaker does the same per-RPC."""
        h = self.health
        # effective_state, not raw state: an idle breaker past its
        # cooldown is "half-open pending first probe", and reporting it
        # open would leave this node unhealthy forever once traffic is
        # routed away (no forwards -> no acquire -> no transition)
        open_peers = sorted(
            p.host
            for p in self.picker.peers()
            if p.breaker is not None
            and p.breaker.effective_state() == BREAKER_OPEN
        )
        if not open_peers:
            return h
        msg = "circuit open: " + ",".join(open_peers)
        if h.message:
            msg = h.message + "|" + msg
        return HealthCheckResp(
            status=UNHEALTHY, message=msg, peer_count=h.peer_count
        )

    # -- membership (gubernator.go:254-310) ---------------------------------

    async def set_peers(self, peers: Sequence[PeerInfo]) -> None:
        others = [p.address for p in peers if not p.is_owner]
        if others:
            raise NotImplementedError(
                f"peers {others}: {FORWARDING_NOT_PORTED}; a ring of "
                f"this node alone is served"
            )
        picker = self.picker.new()
        errs = []
        for info in peers:
            existing = self.picker.get_peer_by_host(info.address)
            if existing is not None:
                peer = existing
            else:
                peer = PeerClient(self.conf.behaviors, info.address)
            peer.is_owner = info.is_owner
            peer.mesh_local = getattr(info, "mesh_local", False)
            try:
                peer.connect()
            except Exception:
                errs.append(
                    f"failed to connect to peer '{info.address}'; "
                    f"consistent hash is incomplete"
                )
                continue
            try:
                picker.add(peer)
            except ValueError as e:
                # crc32 ring-point collision (picker.add): surface it
                # through health instead of silently splitting
                # ownership between tie-break rules (ADVICE r5 #3)
                log.error("%s", e)
                errs.append(str(e))
                # a freshly built client was already connect()ed; close
                # it or every set_peers round leaks a channel + flusher
                # task while the collision persists
                if existing is None:
                    await peer.close()
                continue

        old_hosts = {p.host for p in self.picker.peers()}
        new_hosts = {p.host for p in picker.peers()}
        removed = [
            self.picker.get_peer_by_host(h) for h in old_hosts - new_hosts
        ]

        self.picker = picker
        self.health = HealthCheckResp(
            status=UNHEALTHY if errs else HEALTHY,
            message="|".join(errs),
            peer_count=picker.size(),
        )
        # Unlike the reference (which leaks old clients, gubernator.go:276),
        # departed peers' channels are closed once replaced.
        for peer in removed:
            if peer is not None:
                await peer.close()
        log.info("peers updated: %s", [p.address for p in peers])

    def get_peer(self, key: str) -> PeerClient:
        return self.picker.get(key)

    def peer_list(self) -> List[PeerClient]:
        return self.picker.peers()
