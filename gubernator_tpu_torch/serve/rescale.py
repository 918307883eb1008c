"""Elastic ring rescale: planned state handoff on membership change.

r11 replication covers DEATH of an owner (snapshot to the ring
successor, takeover, reconcile handback). But at fleet scale the ring
changes far more often than nodes die: every rolling deploy
deregisters and re-registers a node, and every autoscale event adds or
removes one — and a ring change silently REASSIGNS ownership with no
state handoff. The new owner of a moved key opens a fresh window, so a
planned deploy un-rate-limits every idle over-limit key it moves (the
consistency window during membership change that PAPERS.md's
scalable-rate-limiting survey names as the core distributed-correctness
problem; the reference Gubernator simply accepts the amnesia).

This module closes it with machinery that already exists — the r11
snapshot surfaces (`snapshot_read`, non-mutating), the ReplicateBuckets
peer RPC and its LWW install rules, and the ring itself
(`ConsistentHashPicker.ownership_diff`):

- Owners track the token-bucket keys they decide (bounded,
  GUBER_RESCALE_TRACK_KEYS; freshest-kept like the r11 standby table).
  Installed handoff/standby seeds are tracked too, so a window a node
  RECEIVED in one rescale survives the next one even if only peeked.
- On every ring change (Instance.set_peers diff), the flush loop
  computes `old_picker.ownership_diff(new_picker, tracked_keys)`,
  snapshot-reads the moved keys' windows (non-mutating; device
  backends on the batcher's serialized submit thread, the r11
  contract) and ships them to each NEW owner over ReplicateBuckets.
  Installs are last-write-wins by (reset_time, snapshot_ms), so
  duplicates and retries no-op — the exact r11 standby discipline.
- Receivers: with replication on, the r11 install path handles both
  halves (owned -> store, not-yet-owned -> standby, seeded on the
  first owned touch). With replication OFF, RescaleManager.install
  provides the same two-way split against its own bounded pending
  table, so GUBER_RESCALE stands alone.
- Double-serve window (GUBER_RESCALE_DOUBLE_SERVE_MS): for a bounded
  window after a ring change, FORWARDERS keep routing moved keys to
  their OLD owner (route_override — one extra ring lookup per
  forwarded request, only while a window is open), whose store is
  still warm, while the new owner installs the handoff; the old owner
  counts these serves (rescale_double_serve_answers_total) and re-dirties
  the keys so the end-of-window flush ships any hits it absorbed.
  When the window closes, forwarding flips to the new owner and LWW
  reconciliation closes any race. A node that LEFT the ring is never
  double-served (its doors are draining); the drain handoff below
  covers that direction instead.
- Drain handoff (Server.drain, BEFORE deregistration): a SIGTERMed
  node ships every tracked window to the owner the ring elects once
  it is gone (ownership_diff against the ring minus self). Receivers
  park the snapshots until their own ring flips, then seed on first
  touch — so the windows are in place before any peer re-routes.
- GUBER_SHARDS changes on the mesh backend re-partition the store
  itself: PartitionedEngine.export_windows reads every live token
  window host-side (the full key hash is reconstructable from each
  entry's L_TAG|L_KEYLOW lanes since r14) and install_windows lays
  them out under the new ShardingPolicy
  (parallel/sharded.py repartition; MeshBackend.repartition).

Deliberate scope (documented in docs/operations.md):

- Token bucket only, the same structural exclusion as r11 (leaky
  refills continuously and self-heals within one leak tick).
- With a static ring, ON is byte-identical to OFF: tracking is two
  dict ops on the owned hot path, the flush loop only acts on ring
  changes, and snapshot reads are non-mutating
  (tests/test_rescale.py pins it differentially, flat and mesh).
- Direct traffic AT the new owner in the handoff-lag window (before
  the old owner's snapshots land) may open a fresh window; the LWW
  install then overwrites it — the fail-closed direction, bounded by
  the handoff lag (metric: rescale_handoff_lag_seconds, target under
  two flush windows). Double-serve closes this window entirely for
  forwarded traffic.
- Chain levels and pre-hashed GEB6/GEB7 windows are outside the
  tracked set (no key strings), the r11 scope limits verbatim.

The port's copy of gubernator_tpu/serve/rescale.py with its imports
rewritten; the file references above are the reference package's.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    millisecond_now,
)
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.replication import Snapshot, snapshot_resp

log = logging.getLogger("gubernator_tpu_torch.rescale")


class RescaleManager:
    """Supervised ring-change handoff loop + owned-key tracking.

    Event-loop confined like GlobalManager/ReplicationManager; the only
    cross-thread work is the device snapshot read, which runs on the
    batcher's single submit thread (DeviceBatcher.run_serialized)."""

    def __init__(self, conf, instance):
        self.conf = conf
        self.instance = instance
        # flush tick shared with r11 (one knob, one staleness story):
        # also the double-serve re-flush cadence
        self.sync_wait = getattr(conf, "replication_sync_wait", 0.1)
        self.track_cap = getattr(conf, "rescale_track_keys", 1 << 16)
        self.double_serve_s = (
            getattr(conf, "rescale_double_serve", 0.5)
        )
        # owner-side: key -> (algo, limit, duration) of the last decide
        # (duration backfill for backends whose rows don't persist it,
        # the r11 Snapshot convention). Freshest-kept at capacity:
        # pop-then-insert so dict order tracks touch recency.
        self._tracked: Dict[str, Tuple[int, int, int]] = {}
        # receiver-side pending table (replication OFF only): snapshots
        # for keys this node does not own YET, LWW by
        # (reset_time, snapshot_ms), popped on the first owned touch —
        # the r11 standby discipline without the takeover machinery
        self._pending: Dict[str, Snapshot] = {}
        # ring transition state: (old_picker, new_picker, deadline_mono)
        # of the latest change; route_override and the double-serve
        # accounting read it, the flush loop retires it
        self._transition = None
        # moved keys of the latest transition awaiting their
        # end-of-window reconcile flush: key -> (algo, limit, duration)
        self._moved: Dict[str, Tuple[int, int, int]] = {}
        self._pending_changes: List[tuple] = []
        self._event = asyncio.Event()
        self._tasks: list = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if not self._tasks:
            from gubernator_tpu_torch.serve.global_mgr import supervise

            self._tasks = [
                asyncio.ensure_future(
                    supervise("rescale", self._run_flush)
                )
            ]

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
        """Planned-departure handoff (Server.drain, BEFORE the
        discovery deregistration): ship every tracked window to the
        owner the ring elects once this node is gone, so the snapshots
        are parked on their new owners before any peer's ring flips.
        No distinct other host (single-node ring) leaves nothing to
        do."""
        picker = self.instance.picker
        minus_self = picker.new()
        for p in picker.peers():
            if not p.is_owner:
                minus_self.add(p)
        if minus_self.size() == 0:
            return
        moved = picker.ownership_diff(minus_self, list(self._tracked))
        if moved:
            await self._handoff(moved, dict(self._tracked),
                                what="drain_handoff")
        if self._pending:
            # parked snapshots for keys whose first owned touch never
            # came (idle windows handed to us in an earlier rescale):
            # they are live state too — forward them to whoever the
            # ring-minus-self elects, or they die with this process
            now = millisecond_now()
            by_host: Dict[str, Tuple] = {}
            for key, s in self._pending.items():
                if s.reset_time <= now:
                    continue
                owner = minus_self.get(key)
                entry = by_host.get(owner.host)
                if entry is None:
                    by_host[owner.host] = (owner, [s])
                else:
                    entry[1].append(s)
            for host, (peer, snaps) in by_host.items():
                await self._send(peer, snaps, what="drain_pending")

    # -- owner-side tracking (hot path: dict ops, only when enabled) --------

    def note_owned(self, r: RateLimitReq) -> None:
        """Track an owned, hit-carrying token-bucket key as holding a
        live window this node must hand off on a ring change. Peeks
        change nothing (a peek cannot create a window; keys kept alive
        by peeks alone were tracked when they were created or
        installed)."""
        if r.hits <= 0 or r.algorithm != Algorithm.TOKEN_BUCKET:
            return
        self._note_key(r.hash_key(), (int(r.algorithm), r.limit, r.duration))

    def note_owned_fields(self, keys, fields, elig=None) -> None:
        """Bridge-tier tracking (edge string->array fold), same gates
        as note_owned; `elig` carries pre-computed
        eligible_field_indices like queue_dirty_fields."""
        from gubernator_tpu_torch.serve.replication import (
            eligible_field_indices,
        )

        if elig is None:
            elig = eligible_field_indices(fields)
        if not elig.size:
            return
        limit = fields["limit"]
        duration = fields["duration"]
        token = int(Algorithm.TOKEN_BUCKET)
        for i in elig.tolist():
            self._note_key(
                keys[i], (token, int(limit[i]), int(duration[i]))
            )

    def note_seeded(self, seeds: List[Tuple[str, Snapshot]]) -> None:
        """Account an installed seed batch (standby takeover or pending
        handoff): track each window for the next ring change and stamp
        the handoff-lag gauge from the snapshots' owner-clock age."""
        for k, s in seeds:
            self.note_installed(k, s.limit, s.duration)
        self._lag_from_snaps(millisecond_now(), [s for _, s in seeds])

    def note_installed(self, key: str, limit: int, duration: int) -> None:
        """Track a window this node INSTALLED (handoff/standby seed or
        reconcile handback): it is live local state this node is now
        responsible for handing off, even if only ever peeked here —
        without this, a window that rode one rescale would amnesia on
        the next."""
        self._note_key(
            key, (int(Algorithm.TOKEN_BUCKET), int(limit), int(duration))
        )

    def _note_key(self, key: str, meta: Tuple[int, int, int]) -> None:
        tracked = self._tracked
        prev = tracked.pop(key, None)
        if prev is None and len(tracked) >= self.track_cap:
            # evict the stalest-touched key (dict order = touch
            # recency under pop-then-insert), counting the loss
            tracked.pop(next(iter(tracked)))
            self._drop("track_evict")
        tracked[key] = meta

    @property
    def tracked_len(self) -> int:
        return len(self._tracked)

    @property
    def pending_len(self) -> int:
        return len(self._pending)

    def _drop(self, what: str) -> None:
        try:
            metrics.RESCALE_DROPPED.labels(what=what).inc()
        except Exception:  # pragma: no cover - defensive
            pass

    # -- ring-change intake (called from Instance.set_peers) ----------------

    def note_ring_change(self, old_picker, new_picker) -> None:
        """Record a membership change; the flush loop performs the
        handoff. Non-blocking — set_peers must not wait on RPCs."""
        if old_picker.size() == 0:
            return  # initial membership: nothing to move
        now = time.monotonic()
        self._transition = (
            old_picker, new_picker, now + self.double_serve_s
        )
        self._pending_changes.append((old_picker, new_picker, now))
        self._event.set()

    def route_override(self, key: str, r: RateLimitReq):
        """Double-serve routing: while the latest ring change's window
        is open, a key whose owner moved keeps routing to its OLD
        owner (still warm) when that host is still in the new ring —
        including THIS node (the returned client then has is_owner set
        and the caller serves locally, counted as a double-serve).
        None = route normally. One extra ring lookup per call, only
        while a transition window is open."""
        tr = self._transition
        if tr is None:
            return None
        old_picker, new_picker, deadline = tr
        if time.monotonic() >= deadline:
            self._transition = None
            return None
        try:
            old = old_picker.get(key)
            new = new_picker.get(key)
        except Exception:  # pragma: no cover - ring flap
            return None
        if old.host == new.host or new.is_owner:
            # unmoved, or this node IS the new owner: serve locally —
            # the handoff seed/install path covers its window
            return None
        if old.is_owner:
            # this node is the OLD owner: keep answering from the warm
            # local store until the window closes (set_peers reuses
            # client objects, so `old` is the live self client)
            self._count_double_serve(r)
            return old
        live = new_picker.get_peer_by_host(old.host)
        return live  # None when the old owner left the ring

    def note_double_serve(self, r: RateLimitReq) -> bool:
        """Old-owner accounting for a peer-forwarded request on a key
        this node no longer owns but is double-serving: count it and
        re-dirty the key so the end-of-window flush ships the window
        (with any hits absorbed here) to the new owner. Returns True
        when the key is inside an open double-serve window."""
        tr = self._transition
        if tr is None:
            return False
        old_picker, _new_picker, deadline = tr
        if time.monotonic() >= deadline:
            return False
        try:
            if not old_picker.get(r.hash_key()).is_owner:
                return False
        except Exception:  # pragma: no cover - ring flap
            return False
        self._count_double_serve(r)
        return True

    def _count_double_serve(self, r: RateLimitReq) -> None:
        if r.algorithm == Algorithm.TOKEN_BUCKET:
            self._moved.setdefault(
                r.hash_key(), (int(r.algorithm), r.limit, r.duration)
            )
        try:
            metrics.RESCALE_DOUBLE_SERVE.inc()
        except Exception:  # pragma: no cover - defensive
            pass

    # -- receiver side (replication OFF; with it on, r11 installs) ----------

    async def install(self, owner: str, snaps: List[Snapshot]) -> None:
        """ReplicateBuckets receive path when ReplicationManager is not
        constructed: snapshots for keys this node OWNS install straight
        into the local store (through Instance.update_peer_globals, so
        the shed cache purges exactly as for a GLOBAL broadcast);
        others park in the bounded pending table, LWW by
        (reset_time, snapshot_ms), until the ring flips and the first
        owned touch seeds them."""
        now = millisecond_now()
        installs: List[Snapshot] = []
        for s in snaps:
            if (
                s.reset_time <= now
                or s.algorithm != int(Algorithm.TOKEN_BUCKET)
            ):
                continue
            try:
                we_own = self.instance.get_peer(s.key).is_owner
            except Exception:
                we_own = False
            if we_own:
                installs.append(s)
                continue
            cur = self._pending.get(s.key)
            if cur is not None and (
                (cur.reset_time, cur.snapshot_ms)
                >= (s.reset_time, s.snapshot_ms)
            ):
                continue
            self._pending.pop(s.key, None)
            self._pending[s.key] = s
            while len(self._pending) > self.track_cap:
                self._pending.pop(next(iter(self._pending)))
                self._drop("pending_evict")
        if installs:
            await self.instance.update_peer_globals(
                [(s.key, snapshot_resp(s)) for s in installs]
            )
            for s in installs:
                self.note_installed(s.key, s.limit, s.duration)
            self._lag_from_snaps(now, installs)
            log.info(
                "rescale: installed %d moved window(s) from '%s'",
                len(installs), owner,
            )

    def pending_purge(self, keys) -> None:
        """Drop pending rows for these keys: an UpdatePeerGlobals
        install means their owner is alive and broadcasting — its
        authoritative status supersedes any handed-off snapshot (the
        r11 standby rule applied to the pending table)."""
        if not self._pending:
            return
        for k in keys:
            self._pending.pop(k, None)

    def pending_pop(self, key: str) -> Optional[Snapshot]:
        """Take the pending handoff snapshot for a key about to be
        decided as owner — the first owned touch after this node's ring
        flipped. Expired rows answer None (the first post-reset touch
        must open a fresh window, the r11 standby rule)."""
        if not self._pending:
            return None
        s = self._pending.pop(key, None)
        if s is None or s.reset_time <= millisecond_now():
            return None
        return s

    def _lag_from_snaps(self, now: int, snaps: List[Snapshot]) -> None:
        try:
            lag_ms = max(now - s.snapshot_ms for s in snaps)
            metrics.RESCALE_HANDOFF_LAG.set(max(0.0, lag_ms / 1000.0))
        except Exception:  # pragma: no cover - defensive
            pass

    # -- flush loop ----------------------------------------------------------

    async def _run_flush(self) -> None:
        while True:
            if self._pending_changes or self._moved:
                # a change is queued (handoff NOW — lag is the
                # contract) or a double-serve window is open (tick at
                # the flush cadence until it closes)
                await asyncio.sleep(
                    0 if self._pending_changes else self.sync_wait
                )
            else:
                await self._event.wait()
                self._event.clear()
                continue
            await self.flush_once()

    async def flush_once(self) -> None:
        """One handoff round: perform every queued ring change's moved-
        key handoff, then re-flush the open double-serve window's moved
        keys (LWW reconcile), retiring the window past its deadline."""
        changes, self._pending_changes = self._pending_changes, []
        for old_picker, new_picker, t_change in changes:
            # diff against the tracked set as of NOW (keys installed
            # since the change was queued are included — freshness only
            # helps). Delivery clients come from the change's own new
            # picker; set_peers reuses client objects, so they are the
            # live connections unless a LATER flip removed the host —
            # those sends fail loudly and the next change's diff
            # re-moves the keys from the current state.
            tracked = dict(self._tracked)
            moved = old_picker.ownership_diff(
                new_picker, list(tracked)
            )
            if not moved:
                continue
            n = await self._handoff(moved, tracked, what="ring_change")
            lag = time.monotonic() - t_change
            try:
                metrics.RESCALE_HANDOFF_LAG.set(lag)
            except Exception:  # pragma: no cover - defensive
                pass
            log.info(
                "rescale: ring change moved %d tracked key(s) to %d "
                "new owner(s) in %.0f ms", n, len(moved), lag * 1e3,
            )
            # arm the double-serve reconcile set: every moved key
            # re-flushes each tick until the window closes
            for _host, (_peer, keys) in moved.items():
                for k in keys:
                    self._moved.setdefault(k, tracked[k])
        if self._moved and not changes:
            # reconcile on the ticks AFTER a change's own handoff —
            # re-snapshotting the identical windows in the same pass
            # would double the device gathers and RPCs at exactly the
            # moment the lag metric measures, with no double-serve
            # hits accrued yet to reconcile
            await self._reconcile_moved()

    async def _reconcile_moved(self) -> None:
        """Re-ship the open window's moved keys to their CURRENT owners
        (LWW: receivers keep the freshest). A key retires from the
        moved set — and from the tracked table — only once its window
        DELIVERED to the new owner or expired out of the store; a
        failed send (new owner's door not ready yet, breaker cooldown
        outlasting the window) keeps it retrying every flush tick even
        past the double-serve deadline, because dropping it would
        strand the window here forever (a later ring change's diff
        only covers keys the OLD ring routed to this node) — the exact
        amnesia this subsystem exists to prevent. Keys the ring moved
        BACK to us (flap) leave the moved set but STAY tracked: they
        are live owned windows again."""
        moved = dict(self._moved)
        by_host: Dict[str, Tuple] = {}
        for key in moved:
            try:
                owner = self.instance.get_peer(key)
            except Exception:
                continue
            if owner.is_owner:
                self._moved.pop(key, None)
                continue
            entry = by_host.get(owner.host)
            if entry is None:
                by_host[owner.host] = (owner, [key])
            else:
                entry[1].append(key)
        done: List[str] = []
        sent = 0
        for host, (peer, keys) in by_host.items():
            snaps = await self._snapshot(
                [(k, moved[k]) for k in keys]
            )
            snap_keys = {s.key for s in snaps}
            # rows missing from the gather expired or evicted: nothing
            # left to move for them
            done.extend(k for k in keys if k not in snap_keys)
            if snaps and await self._send(peer, snaps,
                                          what="reconcile"):
                done.extend(snap_keys)
                sent += len(snaps)
        if sent:
            try:
                metrics.RESCALE_KEYS_MOVED.inc(sent)
            except Exception:  # pragma: no cover - defensive
                pass
        tr = self._transition
        window_open = tr is not None and time.monotonic() < tr[2]
        if not window_open:
            self._transition = None
            for key in done:
                self._moved.pop(key, None)
                self._tracked.pop(key, None)

    async def _handoff(
        self,
        moved: Dict[str, Tuple],
        metas: Dict[str, Tuple[int, int, int]],
        what: str,
    ) -> int:
        """Snapshot-read and ship one work list ({host: (peer, keys)}).
        Returns the number of snapshots delivered (expired/evicted rows
        snapshot to None and drop out — nothing to move)."""
        sent = 0
        for host, (peer, keys) in moved.items():
            snaps = await self._snapshot(
                [(k, metas[k]) for k in keys if k in metas]
            )
            if not snaps:
                continue
            if await self._send(peer, snaps, what=what):
                sent += len(snaps)
        if sent:
            try:
                metrics.RESCALE_KEYS_MOVED.inc(sent)
            except Exception:  # pragma: no cover - defensive
                pass
        return sent

    async def _snapshot(
        self, metas: List[Tuple[str, Tuple[int, int, int]]]
    ) -> List[Snapshot]:
        from gubernator_tpu_torch.serve.replication import snapshot_windows

        return await snapshot_windows(self.instance, metas)

    async def _send(self, peer, snaps: List[Snapshot], what: str) -> bool:
        """One new owner's snapshots over ReplicateBuckets, chunked
        under the peer batch cap; LWW installs make retries and
        duplicate deliveries free. Returns True when every chunk
        landed."""
        advertise = self.conf.resolved_advertise()
        lim = self.conf.behaviors.global_batch_limit
        ok = True
        for i in range(0, len(snaps), lim):
            chunk = snaps[i : i + lim]
            try:
                await peer.replicate_buckets(chunk, owner=advertise)
            except Exception as e:
                ok = False
                log.warning(
                    "rescale: error sending %s snapshots to '%s': %s",
                    what, peer.host, e,
                )
        return ok
