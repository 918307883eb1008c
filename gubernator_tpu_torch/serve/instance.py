"""The serving instance: validation, owner routing, the shed screen and
peer fan-out (the port of gubernator_tpu/serve/instance.py).

The engine-room of one server process, mirroring the reference
Instance's contract (reference gubernator.go:41-322) with an asyncio +
batched-device execution model:

- get_rate_limits validates each entry, decides key ownership on the
  ring, screens the over-limit shed cache (serve/shedcache.py: frozen
  token-bucket refusals answer host-side, before the batcher or any
  forward RPC), and splits the residue three ways: locally-owned
  requests coalesce into device batches; GLOBAL non-owned requests
  answer from local replicas (with hits queued to the gossip manager);
  other non-owned requests forward to their owner peer (micro-batched
  per peer unless NO_BATCHING). Responses reassemble in request order
  (gubernator.go:75-169).
- get_peer_rate_limits serves owner-side batches for other peers
  (gubernator.go:210-227).
- update_peer_globals installs owner-broadcast GLOBAL replicas
  (gubernator.go:199-207), and apply_global_hits_local charges GLOBAL
  hits flushed to this node.
- set_peers rebuilds the picker on membership change, reusing existing
  connections, and recomputes health (gubernator.go:254-292);
  health_check merges in breaker state.

Not ported yet, and refused loudly rather than ignored: bucket
replication, ring rescale and checkpoint/restore (a config that turns
one on raises at construction; with them go the successor takeover and
the owner-side replication hooks), and quota chains (a chained item
gets a per-item error, at the door and at the owner).
Comments name the reference's modules and files.
"""

from __future__ import annotations

import asyncio
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
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.batcher import DeviceBatcher
from gubernator_tpu_torch.serve.breaker import OPEN as BREAKER_OPEN
from gubernator_tpu_torch.serve.config import MAX_BATCH_SIZE, ServerConfig
from gubernator_tpu_torch.serve.faults import FAULTS
from gubernator_tpu_torch.serve.global_mgr import GlobalManager
from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient
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
        local: List[Tuple[int, RateLimitReq, bool]] = []  # idx, req, gnp
        forwards: List[Tuple[int, RateLimitReq, PeerClient]] = []
        t_route0 = time.monotonic()

        # validation pass first so the whole batch's fingerprints hash
        # in one call — the routing pass below consults the over-limit
        # shed cache with them, and the response hooks use them to
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

        for j, (i, r, key) in enumerate(valid):
            h = int(hashes[j])
            fps[i] = h
            try:
                peer = self.get_peer(key)
            except Exception as e:
                out[i] = RateLimitResp(
                    error=(
                        f"while finding peer that owns rate limit "
                        f"'{key}' - '{e}'"
                    )
                )
                continue
            # over-limit shed screen (serve/shedcache.py): a cached
            # frozen refusal answers here — no batcher, no forward RPC.
            # GLOBAL side effects are preserved exactly as the
            # non-shed path would produce them: non-owners still
            # aggregate the hit toward the owner, owners still queue
            # the status broadcast (the broadcast loop's peeks carry
            # hits=0 and therefore always bypass the shed).
            verdict = (
                shed.lookup_resp(h, r) if shed is not None else None
            )
            if peer.is_owner:
                if verdict is not None:
                    if r.behavior == Behavior.GLOBAL:
                        self.global_mgr.queue_update(r)
                    out[i] = verdict
                    continue
                local.append((i, r, False))
            elif r.behavior == Behavior.GLOBAL:
                # replica answer + async hit forward (gubernator.go:133-140)
                self.global_mgr.queue_hit(r)
                if verdict is not None:
                    out[i] = verdict
                    continue
                local.append((i, r, True))
            else:
                if verdict is not None:
                    # parity with forward(): forwarded answers carry
                    # the owner tag, shed or not
                    verdict.metadata["owner"] = peer.host
                    out[i] = verdict
                    continue
                forwards.append((i, r, peer))

        if valid:
            self.traffic.observe([k for _, _, k in valid], hashes)
        # instance-side routing overhead (validation + ring lookups +
        # shed screen + sketches), attributed apart from the batcher's
        # queue/device stages
        STAGES.add("instance_route", time.monotonic() - t_route0)

        async def forward(i, r, peer):
            key = r.hash_key()
            tr = tracing.active()
            t_fwd = time.monotonic() if tr is not None else 0.0
            try:
                resp = await peer.get_peer_rate_limit(r)
                if tr is not None:
                    tr.add_span(
                        "peer_forward", start=t_fwd,
                        peer=peer.host, items=1,
                    )
                resp.metadata["owner"] = peer.host
                if shed is not None:
                    shed.observe_resps([fps[i]], [r], [resp])
            except Exception as e:
                degraded = await self._degraded_fallback([(i, r)], peer, e)
                if degraded is not None:
                    out[i] = degraded[0]
                    return
                resp = RateLimitResp(
                    error=(
                        f"while fetching rate limit '{key}' from peer - '{e}'"
                    )
                )
            out[i] = resp

        async def forward_group(peer, items):
            # owner batching (r7): the whole per-owner group rides ONE
            # queue entry + ONE future through the peer's micro-batch
            # flusher. Failures keep per-item error parity with forward().
            tr = tracing.active()
            t_fwd = time.monotonic() if tr is not None else 0.0
            try:
                resps = await peer.get_peer_rate_limits_grouped(
                    [r for _, r in items]
                )
                if tr is not None:
                    tr.add_span(
                        "peer_forward", start=t_fwd,
                        peer=peer.host, items=len(items),
                    )
                for (i, r), resp in zip(items, resps):
                    resp.metadata["owner"] = peer.host
                    out[i] = resp
                if shed is not None:
                    shed.observe_resps(
                        [fps[i] for i, _ in items],
                        [r for _, r in items],
                        resps,
                    )
            except Exception as e:
                degraded = await self._degraded_fallback(items, peer, e)
                if degraded is not None:
                    for (i, _), resp in zip(items, degraded):
                        out[i] = resp
                    return
                for i, r in items:
                    out[i] = RateLimitResp(
                        error=(
                            f"while fetching rate limit "
                            f"'{r.hash_key()}' from peer - '{e}'"
                        )
                    )

        # group BATCHING forwards per owner; NO_BATCHING keeps its
        # direct-unary contract (reference peers.go:73-90)
        grouped: dict = {}
        singles = []
        for i, r, peer in forwards:
            if r.behavior == Behavior.NO_BATCHING:
                singles.append((i, r, peer))
            else:
                grouped.setdefault(peer, []).append((i, r))

        # schedule forwards immediately so their RPCs overlap the local
        # device batch instead of queueing behind it
        tasks = [
            asyncio.ensure_future(forward(i, r, p)) for i, r, p in singles
        ]
        tasks += [
            asyncio.ensure_future(forward_group(p, items))
            for p, items in grouped.items()
        ]

        if local:
            local_reqs = [r for _, r, _ in local]
            gnp = [g for _, _, g in local]
            try:
                resps = await self.decide_local(
                    local_reqs, gnp, frame=stage_frame
                )
                for (i, _, _), resp in zip(local, resps):
                    out[i] = resp
                if shed is not None:
                    shed.observe_resps(
                        [fps[i] for i, _, _ in local], local_reqs, resps
                    )
            except Exception as e:
                for i, r, _ in local:
                    out[i] = RateLimitResp(
                        error=(
                            f"while applying rate limit for "
                            f"'{r.hash_key()}' - '{e}'"
                        )
                    )
        if tasks:
            await asyncio.gather(*tasks)
        return [r if r is not None else RateLimitResp() for r in out]

    async def _degraded_fallback(self, items, peer, exc):
        """Degraded mode (GUBER_DEGRADED_LOCAL=1): a forward that failed
        with its owner unreachable is answered from the LOCAL store,
        stamped metadata["degraded"]="true" — availability over global
        accuracy, the reference's documented eventual-consistency
        stance, opt-in. `items`: [(out_index, req)]. Returns the
        responses or None (mode off / local decide itself failed →
        caller surfaces the original per-item error)."""
        if not getattr(self.conf, "degraded_local", False):
            return None
        try:
            resps = await self.decide_local(
                [r for _, r in items], [False] * len(items)
            )
        except Exception:
            return None
        for resp in resps:
            resp.metadata["degraded"] = "true"
            resp.metadata["owner"] = peer.host
        log.warning(
            "degraded mode: answered %d item(s) locally, owner '%s' "
            "unreachable (%s)", len(items), peer.host, exc,
        )
        try:
            metrics.DEGRADED_RESPONSES.inc(len(items))
        except Exception:  # pragma: no cover - defensive
            pass
        return resps

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

    # -- peer-facing API ----------------------------------------------------

    async def get_peer_rate_limits(
        self, reqs: Sequence[RateLimitReq]
    ) -> List[RateLimitResp]:
        if len(reqs) > MAX_BATCH_SIZE:
            raise BatchTooLargeError(
                f"'PeerRequest.rate_limits' list too large; max size is "
                f"'{MAX_BATCH_SIZE}'"
            )
        try:
            if FAULTS.enabled:
                # owner-side injection point: a chaos spec can make THIS
                # node a slow/failing owner for its peers' forwards
                await FAULTS.inject("peer_serve")
            if not any(r.chain for r in reqs):
                return await self._peer_serve_plain(reqs)
            # a chained item forwarded by a peer that serves chains gets
            # the same per-item error as at this node's own door
            plain = [(i, r) for i, r in enumerate(reqs) if not r.chain]
            out = [RateLimitResp(error=CHAINS_NOT_PORTED) for _ in reqs]
            if plain:
                presps = await self._peer_serve_plain([r for _, r in plain])
                for (i, _), resp in zip(plain, presps):
                    out[i] = resp
            return out
        except Exception as e:
            return [RateLimitResp(error=str(e)) for _ in reqs]

    async def _peer_serve_plain(
        self, reqs: Sequence[RateLimitReq]
    ) -> List[RateLimitResp]:
        """The owner-side decide for forwarded batches: shed screen +
        device decide."""
        try:
            shed = self.shed
            if shed is None:
                return await self.decide_local(reqs, [False] * len(reqs))
            # owner-side shed screen: forwarded items for a frozen
            # over-limit key are answered without a device trip; the
            # residue decides normally and its responses populate the
            # cache. Forwarded GLOBAL hits keep their broadcast side
            # effect (decide_local would have queued the update).
            shed.refresh_generation()
            hashes = slot_hash_batch([r.hash_key() for r in reqs])
            out: List[Optional[RateLimitResp]] = [None] * len(reqs)
            residue: List[Tuple[int, RateLimitReq]] = []
            res_fps: List[int] = []
            for i, r in enumerate(reqs):
                verdict = shed.lookup_resp(int(hashes[i]), r)
                if verdict is not None:
                    if r.behavior == Behavior.GLOBAL:
                        self.global_mgr.queue_update(r)
                    out[i] = verdict
                else:
                    residue.append((i, r))
                    res_fps.append(int(hashes[i]))
            if residue:
                resps = await self.decide_local(
                    [r for _, r in residue], [False] * len(residue)
                )
                shed.observe_resps(
                    res_fps, [r for _, r in residue], resps
                )
                for (i, _), resp in zip(residue, resps):
                    out[i] = resp
            return [
                o if o is not None else RateLimitResp() for o in out
            ]
        except Exception as e:
            return [RateLimitResp(error=str(e)) for _ in reqs]

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
