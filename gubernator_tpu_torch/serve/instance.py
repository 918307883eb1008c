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
- hierarchical quota chains: a chained request is validated
  (chain_error), routed by its chain HEAD's key so one owner debits the
  whole chain, kept out of the shed cache, and decided on the batcher's
  chain lane (no partial debit, most restrictive wins), at the client
  door, the peer door and in degraded mode alike.

- the durability managers, each off by default: bucket replication
  (serve/replication.py: owner-side dirtying, the successor takeover with
  its standby seeds, the reconcile handback), ring rescale
  (serve/rescale.py: owned-key tracking, double-serve routing, pending
  handoff seeds) and checkpoint/restore (serve/checkpoint.py: tracking
  and parked import seeds); `replicate_buckets` is their receive path.
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
from gubernator_tpu_torch.serve.checkpoint import CheckpointManager
from gubernator_tpu_torch.serve.config import MAX_BATCH_SIZE, ServerConfig
from gubernator_tpu_torch.serve.faults import FAULTS
from gubernator_tpu_torch.serve.global_mgr import GlobalManager
from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient
from gubernator_tpu_torch.serve.replication import ReplicationManager, snapshot_resp
from gubernator_tpu_torch.serve.rescale import RescaleManager
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.instance")

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"


class BatchTooLargeError(ValueError):
    pass


def chain_error(r: RateLimitReq, conf: ServerConfig) -> str:
    """Validation of a hierarchical quota chain: '' when the chain is
    acceptable, else the per-item error string."""
    if not conf.chains:
        return "quota chains are disabled (GUBER_CHAINS=0)"
    if len(r.chain) > conf.chain_max_depth:
        return (
            f"chain has {len(r.chain)} ancestor levels; "
            f"GUBER_CHAIN_MAX_DEPTH allows {conf.chain_max_depth}"
        )
    if r.behavior == Behavior.GLOBAL:
        # GLOBAL's replica/broadcast machinery is per-key; a chain must
        # debit all levels atomically on one owner — incompatible
        return "behavior GLOBAL is incompatible with a quota chain"
    for lv in r.chain:
        if not lv.unique_key:
            return "chain level 'unique_key' cannot be empty"
    return ""


class Instance:
    def __init__(self, conf: ServerConfig, backend):
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
        # the durability managers, each off by default: bucket
        # replication (owned windows snapshot to each key's ring
        # successor, so a killed owner's state survives takeover), ring
        # rescale (moved keys' windows ship to their new owners on a
        # membership change) and checkpoint/restore (to local disk and/or
        # a blue-green import stream). All three read windows through the
        # backend's non-mutating snapshot surface: a backend without one
        # is refused at boot
        ckpt_on = bool(conf.checkpoint_dir or conf.checkpoint_export_peers)
        for knob, on in (
            ("GUBER_REPLICATION=1", conf.replication),
            ("GUBER_RESCALE=1", conf.rescale),
            ("GUBER_CHECKPOINT_DIR / GUBER_CHECKPOINT_EXPORT_PEERS", ckpt_on),
        ):
            if on and getattr(backend, "snapshot_read", None) is None:
                raise ValueError(
                    f"{knob} needs a backend with a non-mutating "
                    f"snapshot_read surface (exact/tpu); backend "
                    f"'{conf.backend}' does not expose one"
                )
        self.repl = ReplicationManager(conf, self) if conf.replication else None
        self.rescale = RescaleManager(conf, self) if conf.rescale else None
        self.checkpoint = CheckpointManager(conf, self) if ckpt_on else None
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
        if self.repl is not None:
            self.repl.start()
        if self.rescale is not None:
            self.rescale.start()
        if self.checkpoint is not None:
            self.checkpoint.start()
        if self.promoter is not None:
            self.promoter.start()

    async def stop(self) -> None:
        if self.promoter is not None:
            await self.promoter.stop()
        if self.checkpoint is not None:
            await self.checkpoint.stop()
        if self.rescale is not None:
            await self.rescale.stop()
        if self.repl is not None:
            await self.repl.stop()
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
                err = chain_error(r, self.conf)
                if err:
                    out[i] = RateLimitResp(error=err)
                    continue
            valid.append((i, r, r.hash_key()))

        hashes = (
            slot_hash_batch([k for _, _, k in valid]) if valid else None
        )
        shed = self.shed
        if shed is not None:
            shed.refresh_generation()
        repl = self.repl
        resc = self.rescale
        ckpt = self.checkpoint
        # takeover/handoff seeds: owned first touches whose key has a
        # replicated standby snapshot, a pending rescale handoff or a
        # parked checkpoint import install it BEFORE deciding
        seeds: List[Tuple[int, str, object]] = []
        fps = {}

        chain_local: List[Tuple[int, RateLimitReq]] = []
        for j, (i, r, key) in enumerate(valid):
            h = int(hashes[j])
            fps[i] = h
            try:
                # chained requests route by the chain HEAD's key so one
                # owner debits the whole chain atomically
                peer = self.get_peer(r.routing_key() if r.chain else key)
            except Exception as e:
                out[i] = RateLimitResp(
                    error=(
                        f"while finding peer that owns rate limit "
                        f"'{key}' - '{e}'"
                    )
                )
                continue
            if r.chain:
                # the shed cache is bypassed for chains: a cached LEAF
                # verdict cannot speak for the parent levels, and a
                # collapsed chain response must never populate a
                # leaf-fingerprint entry (the observe calls below are
                # chain-gated too)
                if peer.is_owner:
                    chain_local.append((i, r))
                else:
                    forwards.append((i, r, peer))
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
            if not peer.is_owner and resc is not None and (
                resc._transition is not None
                and r.behavior != Behavior.GLOBAL
            ):
                # double-serve routing: while a ring change's window is
                # open, MOVED keys keep forwarding to their old (warm)
                # owner, or serve locally when that is this node, until
                # the new owner has installed the handoff. GLOBAL items
                # keep their replica-answer semantics; chained requests
                # never reach here (the chain branch above continued)
                ov = resc.route_override(key, r)
                if ov is not None:
                    peer = ov
            if peer.is_owner:
                if repl is not None:
                    repl.queue_dirty(r)
                if resc is not None:
                    resc.note_owned(r)
                if ckpt is not None:
                    ckpt.note_owned(r)
                if verdict is not None:
                    if r.behavior == Behavior.GLOBAL:
                        self.global_mgr.queue_update(r)
                    out[i] = verdict
                    continue
                s = repl.standby_pop(key) if repl is not None else None
                if s is None and resc is not None:
                    s = resc.pending_pop(key)
                if s is None and ckpt is not None:
                    s = ckpt.pending_pop(key)
                if s is not None:
                    seeds.append((i, key, s))
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
                if shed is not None and not r.chain:
                    shed.observe_resps([fps[i]], [r], [resp])
            except Exception as e:
                taken = await self._takeover_fallback([(i, r)], peer, e)
                if taken is not None:
                    out[i] = taken[0]
                    return
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
                    # collapsed chain responses never seed
                    # leaf-fingerprint entries
                    plain = [
                        (i, r, resp)
                        for (i, r), resp in zip(items, resps)
                        if not r.chain
                    ]
                    if plain:
                        shed.observe_resps(
                            [fps[i] for i, _, _ in plain],
                            [r for _, r, _ in plain],
                            [resp for _, _, resp in plain],
                        )
            except Exception as e:
                taken = await self._takeover_fallback(items, peer, e)
                if taken is not None:
                    for (i, _), resp in zip(items, taken):
                        out[i] = resp
                    return
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

        if chain_local:
            # owned chains ride the batcher's chain lane, overlapped with
            # the plain local batch below. Frame attribution: a chain-only
            # frame's stage span rides the chain lane; a frame with BOTH
            # plain and chained local work flags only the plain lane (one
            # frame contributes one batch_queue/device span)
            chain_frame = stage_frame and not local

            async def chain_decide(items):
                try:
                    resps = await self.batcher.decide_chain(
                        [r for _, r in items], frame=chain_frame
                    )
                    for (i, _), resp in zip(items, resps):
                        out[i] = resp
                except Exception as e:
                    for i, r in items:
                        out[i] = RateLimitResp(
                            error=(
                                f"while applying chained rate limit "
                                f"for '{r.hash_key()}' - '{e}'"
                            )
                        )

            tasks.append(asyncio.ensure_future(chain_decide(chain_local)))

        seeded_idx: List[int] = []
        if seeds:
            # install the standby snapshots BEFORE the batch decides; the
            # awaited install funnels through the same flusher queue as
            # the decide, so the first owned touch continues the dead
            # owner's window
            seeded_idx = await self._seed_standby(seeds)
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
        for i in seeded_idx:
            resp = out[i]
            if resp is not None and not resp.error:
                resp.metadata["replicated"] = "true"
        return [r if r is not None else RateLimitResp() for r in out]

    async def _install_seeds(self, seeds) -> bool:
        """Install popped standby snapshots ((key, Snapshot) pairs)
        into the local store through the UpdatePeerGlobals machinery —
        which also purges shed-cache entries for those keys, keeping
        the r10 invalidation rules intact. Returns False on install
        failure: the caller's decide then proceeds un-seeded (a fresh
        window — amnesia for those keys, not an outage)."""
        try:
            await self.update_peer_globals(
                [(k, snapshot_resp(s)) for k, s in seeds]
            )
        except Exception as e:
            log.warning("standby seed install failed: %s", e)
            return False
        if self.repl is not None:
            self.repl.note_seeded(seeds)
        if self.rescale is not None:
            # a seeded window is live local state this node must hand
            # off on the NEXT ring change, even if only peeked here
            self.rescale.note_seeded(seeds)
        if self.checkpoint is not None:
            # likewise live state the next checkpoint must capture
            self.checkpoint.note_seeded(seeds)
        return True

    async def _seed_standby(self, seeds) -> List[int]:
        """(out_index, key, Snapshot) triples -> installed; returns the
        out-indices seeded (their responses get
        metadata["replicated"]="true")."""
        if not await self._install_seeds([(k, s) for _, k, s in seeds]):
            return []
        return [i for i, _, _ in seeds]

    async def _takeover_local(self, reqs: Sequence[RateLimitReq]):
        """Decide items locally in a dead owner's stead (this node is
        their ring successor): seed first touches from the standby
        table, and track every key for the reconcile handback once the
        owner returns."""
        repl = self.repl
        seeds = []
        for r in reqs:
            repl.mark_taken(r)
            s = repl.standby_pop(r.hash_key())
            if s is not None:
                seeds.append((r.hash_key(), s))
        if seeds:
            await self._install_seeds(seeds)
        return await self.decide_local(reqs, [False] * len(reqs))

    async def _takeover_fallback(self, items, peer, exc):
        """Successor takeover (GUBER_REPLICATION=1): a forward that
        failed because its owner is unreachable (breaker open — which
        fails fast, so this is usually cheap — retries exhausted, or
        deadline) is routed to each key's ring SUCCESSOR: the node the
        consistent hash elects on owner removal, and the one holding
        the replicated standby snapshots. Served locally when the
        successor is this node, via one forwarded group otherwise (the
        remote successor seeds from its own standby table in
        get_peer_rate_limits). Responses carry metadata owner=successor
        and replicated="true". Returns the responses or None
        (replication off / no distinct successor / successor also
        unreachable — the caller then falls through to degraded mode
        and per-item errors, the r8 ladder)."""
        repl = self.repl
        if repl is None:
            return None
        out: List[Optional[RateLimitResp]] = [None] * len(items)
        by_succ: dict = {}
        for j, (_, r) in enumerate(items):
            if r.chain:
                # chains are outside the replication scope (documented
                # r15 limit): no standby snapshot holds level state,
                # and deciding only the leaf here would silently skip
                # every ancestor quota — refuse honestly instead
                out[j] = RateLimitResp(
                    error=(
                        f"owner '{peer.host}' unreachable and chained "
                        f"requests are outside the takeover scope "
                        f"(chain levels are not replicated) - '{exc}'"
                    )
                )
                continue
            try:
                if self.picker.get_peer_by_host(peer.host) is None:
                    # the ring changed under the forward and dropped its
                    # owner (set_peers closed the client mid-batch): the
                    # node the hash elects on that removal is the key's
                    # owner in the ring as it is now, and the one the
                    # departing owner's drain handed the window to. The
                    # current ring's successor would be the node after
                    # it, holding neither. (The reference takes the
                    # current ring's successor here too; ROADMAP Queue 3
                    # item 2 lists this divergence.)
                    succ = self.picker.get(r.hash_key())
                else:
                    succ = self.picker.get_successor(r.hash_key())
            except Exception:
                succ = None
            if succ is None or succ.host == peer.host:
                return None
            by_succ.setdefault(succ, []).append(j)
        try:
            for succ, idxs in by_succ.items():
                reqs = [items[j][1] for j in idxs]
                if succ.is_owner:
                    resps = await self._takeover_local(reqs)
                else:
                    resps = await succ.get_peer_rate_limits_grouped(reqs)
                for j, resp in zip(idxs, resps):
                    if not resp.error:
                        resp.metadata["owner"] = succ.host
                        resp.metadata["replicated"] = "true"
                    out[j] = resp
        except Exception as e2:
            log.warning(
                "takeover route for %d item(s) failed (owner '%s': %s; "
                "successor: %s)", len(items), peer.host, exc, e2,
            )
            return None
        return out

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
            # chained items keep FULL chain semantics against the local
            # store (every level, no partial debit) through the chain
            # lane: a leaf-only decide would skip their ancestor quotas
            resps: List[Optional[RateLimitResp]] = [None] * len(items)
            for chained, decide in (
                (True, self.batcher.decide_chain),
                (False, lambda rs: self.decide_local(rs, [False] * len(rs))),
            ):
                idx = [j for j, (_, r) in enumerate(items) if bool(r.chain) == chained]
                if idx:
                    for j, resp in zip(idx, await decide([items[j][1] for j in idx])):
                        resps[j] = resp
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
            if self.repl is not None or self.rescale is not None:
                await self._peer_serve_replication(reqs)
            chained_idx = [i for i, r in enumerate(reqs) if r.chain]
            if not chained_idx:
                return await self._peer_serve_plain(reqs)
            # forwarded chains decide on THIS node's chain lane (the
            # forwarder routed them here by the chain head), past the
            # shed cache. Validation runs with the RECEIVING node's
            # config: the kill switch, the depth bound (the device-row
            # expansion a hostile peer could otherwise demand) and the
            # GLOBAL check hold at every door
            out: List[Optional[RateLimitResp]] = [None] * len(reqs)
            ok_idx = []
            for i in chained_idx:
                err = chain_error(reqs[i], self.conf)
                if err:
                    out[i] = RateLimitResp(error=err)
                else:
                    ok_idx.append(i)
            if ok_idx:
                cresps = await self.batcher.decide_chain([reqs[i] for i in ok_idx])
                for i, resp in zip(ok_idx, cresps):
                    out[i] = resp
            plain = [(i, r) for i, r in enumerate(reqs) if not r.chain]
            if plain:
                presps = await self._peer_serve_plain([r for _, r in plain])
                for (i, _), resp in zip(plain, presps):
                    out[i] = resp
            return [o if o is not None else RateLimitResp() for o in out]
        except Exception as e:
            return [RateLimitResp(error=str(e)) for _ in reqs]

    async def _peer_serve_plain(
        self, reqs: Sequence[RateLimitReq]
    ) -> List[RateLimitResp]:
        """The owner-side decide for PLAIN (non-chained) forwarded
        batches: shed screen + device decide."""
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

    async def _peer_serve_replication(
        self, reqs: Sequence[RateLimitReq]
    ) -> None:
        """Owner-side replication/rescale hooks for a forwarded batch:
        owned keys dirty the snapshot queue and the rescale tracked
        set; keys the ring says ANOTHER node owns were routed here by a
        peer's takeover fallback or by double-serve routing after a
        ring change — track them for the reconcile handback and count
        the double-serve answer; and any first touch with a standby
        snapshot or pending handoff seeds the store before the batch
        decides."""
        repl = self.repl
        resc = self.rescale
        ckpt = self.checkpoint
        seeds = []
        for r in reqs:
            if r.chain:
                # chain levels are outside the replication scope (r15
                # documented limit, like leaky): level keys are owned
                # by the chain head's ring position, not their own
                continue
            key = r.hash_key()
            try:
                own = self.get_peer(key).is_owner
            except Exception:
                own = True
            if own:
                if repl is not None:
                    repl.queue_dirty(r)
                if resc is not None:
                    resc.note_owned(r)
                if ckpt is not None:
                    ckpt.note_owned(r)
            else:
                if repl is not None:
                    repl.mark_taken(r)
                if resc is not None:
                    # the old owner answering a moved key inside its
                    # double-serve window (forwarders still route it
                    # here): counted, and re-dirtied for the
                    # end-of-window reconcile flush
                    resc.note_double_serve(r)
            s = repl.standby_pop(key) if repl is not None else None
            if s is None and resc is not None and own:
                s = resc.pending_pop(key)
            if s is None and ckpt is not None and own:
                s = ckpt.pending_pop(key)
            if s is not None:
                seeds.append((key, s))
        if seeds:
            await self._install_seeds(seeds)

    async def replicate_buckets(self, owner: str, snaps) -> None:
        """ReplicateBuckets receive path (peers.proto): file or install
        another owner's bucket snapshots. With replication on, the r11
        install handles both halves (owned -> store, others ->
        standby); with only rescale on, its install provides the same
        split against the pending handoff table. A node with both off
        accepts and ignores — knob/version skew across the fleet must
        not fail the sender."""
        if self.checkpoint is not None and (
            owner.startswith("import:") or owner.startswith("importfwd:")
        ):
            # blue-green import batch (r19): the owner marker routes it
            # to the checkpoint manager REGARDLESS of repl/rescale
            # knobs — the green fleet's import handling must not depend
            # on matching the blue fleet's replication config
            await self.checkpoint.install_import(owner, snaps)
        elif self.repl is not None:
            await self.repl.install(owner, snaps)
        elif self.rescale is not None:
            await self.rescale.install(owner, snaps)
        elif self.checkpoint is not None:
            await self.checkpoint.install(owner, snaps)

    # -- GLOBAL replica installs -------------------------------------------

    async def update_peer_globals(
        self, updates: Sequence[Tuple[str, RateLimitResp]]
    ) -> None:
        if self.repl is not None and updates:
            # an owner broadcasting status for these keys is alive and
            # authoritative: any replicated standby snapshot for them is
            # superseded (the reconcile contract)
            self.repl.standby_purge([k for k, _ in updates])
        if self.rescale is not None and updates:
            # the same supersession rule for pending handoff snapshots
            self.rescale.pending_purge([k for k, _ in updates])
        if self.checkpoint is not None and updates:
            # and for parked checkpoint-import rows
            self.checkpoint.pending_purge([k for k, _ in updates])
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

        old_picker = self.picker
        self.picker = picker
        if old_hosts != new_hosts:
            if self.rescale is not None:
                # planned handoff: the flush loop diffs the old ring
                # against the new one and ships moved keys' windows to
                # their new owners; non-blocking here
                self.rescale.note_ring_change(old_picker, picker)
            if self.repl is not None:
                # standby hygiene: rows whose keys this node no longer
                # succeeds (or owns) after the reshuffle could seed a
                # WRONG takeover window later; purge them now
                await self.repl.purge_unsucceeded_standby()
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
