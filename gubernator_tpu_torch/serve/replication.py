"""Owner->successor bucket replication: node death without quota amnesia.

r8 made node failure *graceful* (breakers trip, victims' keys get
degraded-local answers) but a SIGKILLed owner still lost every bucket it
owned: after takeover or restart each key started from a full window, so
a fleet-wide deploy briefly un-rate-limited every hot key — the core
consistency/availability trade-off the scalable-rate-limiting survey
(PAPERS.md) flags for distributed limiters. This module closes it by
piggybacking on machinery that already exists: the ring defines each
key's successor (peers.ConsistentHashPicker), the gossip tier already
moves per-key status between peers (UpdatePeerGlobals install path), and
the store exposes a non-mutating snapshot read of owned rows.

Shape mirrors GlobalManager (supervise/flush/drain):

- Owners mark each decided token-bucket key dirty (queue_dirty, bounded
  by GUBER_REPLICATION_BACKLOG). Every GUBER_REPLICATION_SYNC_WAIT_MS
  the flush loop snapshot-reads the dirty keys' windows — NON-MUTATING
  (backends.snapshot_read / engine.snapshot_read), so replication ON is
  byte-identical to OFF in the no-failure case — and ships
  BucketSnapshots to each key's ring successor over the new
  ReplicateBuckets peer RPC. Installs are last-write-wins by
  (reset_time, snapshot_ms), so retries and duplicates are idempotent.
- Receivers file snapshots for keys they do NOT own in a bounded
  standby table (GUBER_REPLICATION_STANDBY_KEYS) that is consulted ONLY
  on takeover; snapshots for keys they DO own (the reconcile handback
  below) install straight into the local store through the existing
  UpdatePeerGlobals machinery — which also purges the shed cache, so
  the r10 device-authoritative invalidation rules apply unchanged.
- Takeover: when a key's owner dies, its traffic reaches the successor
  either because discovery removed the owner (the ring now routes
  there) or because the forwarding node's breaker opened and it
  re-routed to the successor (instance._takeover_fallback). The
  successor's FIRST touch of such a key pops the standby snapshot and
  installs it before deciding, so the decision continues the dead
  owner's window instead of opening a fresh one; those responses carry
  metadata["replicated"]="true" and count in
  replicated_takeovers_total, with replication_lag_seconds set from
  the snapshot's owner-clock stamp.
- Reconcile: keys served in another owner's stead are tracked (_taken);
  each flush tick they are snapshot-read and handed BACK to their
  current ring owner via the same ReplicateBuckets RPC (the attempt
  doubles as a breaker probe, so the handback typically lands within
  one cooldown of the owner returning). The returning owner installs
  them store-directly; its own next GLOBAL broadcast then supersedes
  any interim successor state, and UpdatePeerGlobals installs purge
  matching standby rows on every receiver.

Deliberate scope (documented in docs/operations.md):

- Token bucket only — a leaky bucket refills continuously (its state
  changes every millisecond and self-heals within one leak tick), the
  same structural exclusion as the r10 shed cache. The wire message
  carries `algorithm` for forward compatibility.
- A standby seed OVERWRITES whatever window the successor's traffic
  may have created mid-takeover (e.g. through the pre-hashed edge fast
  path, which does not consult the standby table) — the fail-closed
  direction for a rate limiter, bounded by the original window.
- Pre-hashed edge frames (GEB6/GEB7) carry no key strings, so windows
  driven EXCLUSIVELY through them are never dirtied for replication;
  the bridge's string->array fold (queue_dirty_fields) and every
  instance path are covered.
- Keys decided but never flushed before the owner died (at most one
  sync window's worth) are lost, as are keys whose successor also died:
  the staleness/loss bound is one flush window + one RTT.

The port's copy of gubernator_tpu/serve/replication.py with its imports
rewritten; the file references above are the reference package's.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    RateLimitResp,
    Status,
    millisecond_now,
)
from gubernator_tpu_torch.serve import metrics

log = logging.getLogger("gubernator_tpu_torch.replication")

#: rough per-entry host footprint of a standby row (dict node + key
#: string + Snapshot tuple), for the boot-time sizing log
ENTRY_BYTES = 400


class Snapshot(NamedTuple):
    """One owned bucket window on the wire (peers.proto BucketSnapshot)."""

    key: str
    algorithm: int
    limit: int
    duration: int
    remaining: int
    reset_time: int  # unix-ms; the last-write-wins version
    status: int  # Status enum value (carries "sticky over")
    snapshot_ms: int  # owner's clock at snapshot time (lag metric)


def snapshot_resp(s: Snapshot) -> RateLimitResp:
    """The store-install form of a snapshot: exactly what the owner's
    window would answer, installed through the UpdatePeerGlobals
    machinery (exact backend: a cached RateLimitResp IS a token window;
    device backends: upsert_globals_jit)."""
    return RateLimitResp(
        status=Status(s.status),
        limit=s.limit,
        remaining=s.remaining,
        reset_time=s.reset_time,
    )


def footprint_mib(keys: int) -> float:
    return keys * ENTRY_BYTES / (1 << 20)


def eligible_field_indices(fields):
    """Indices of hit-carrying token-bucket rows in one folded frame's
    dense field arrays — the single eligibility rule the r11 dirty
    marking and the r17 tracked-set marking share (the bridge computes
    it once per frame and hands it to both managers)."""
    import numpy as np

    return np.flatnonzero(
        (np.asarray(fields["hits"]) > 0)
        & (np.asarray(fields["algo"]) == int(Algorithm.TOKEN_BUCKET))
    )


async def snapshot_windows(
    instance, metas: List[Tuple[str, Tuple[int, int, int]]]
) -> List["Snapshot"]:
    """Non-mutating window read for (key, (algo, limit, duration))
    pairs through the backend's snapshot surface — the ONE gather both
    the r11 replication flush and the r17 rescale handoff use, so the
    thread contract (device backends on the batcher's serialized
    submit thread), the expiry filtering, the duration backfill, and
    the LWW stamping can never drift between them. Expired/missing
    rows drop out."""
    from gubernator_tpu_torch.api.types import Status

    be = instance.backend
    fn = getattr(be, "snapshot_read", None)
    if fn is None:  # pragma: no cover - gated at Instance init
        return []
    keys = [k for k, _ in metas]
    if not keys:
        return []
    now = millisecond_now()
    if getattr(be, "inline_decide", False):
        rows = fn(keys, now)
    else:
        rows = await instance.batcher.run_serialized(fn, keys, now)
    snaps = []
    for (key, meta), row in zip(metas, rows):
        if row is None:
            continue
        limit, duration, remaining, reset_time, over = row
        if reset_time <= now:
            continue
        snaps.append(Snapshot(
            key=key,
            algorithm=int(Algorithm.TOKEN_BUCKET),
            limit=int(limit),
            # exact-backend token windows don't persist duration;
            # fall back to the dirtying request's
            duration=int(duration) if duration > 0 else int(meta[2]),
            remaining=int(remaining),
            reset_time=int(reset_time),
            status=int(
                Status.OVER_LIMIT if over else Status.UNDER_LIMIT
            ),
            snapshot_ms=now,
        ))
    return snaps


class ReplicationManager:
    """Supervised owner->successor snapshot loop + receiver tables.

    Event-loop confined like GlobalManager; the only cross-thread work
    is the device snapshot read, which runs on the batcher's single
    submit thread (DeviceBatcher.run_serialized) so it can never race a
    store-donating dispatch."""

    def __init__(self, conf, instance):
        self.conf = conf
        self.instance = instance
        self.sync_wait = getattr(conf, "replication_sync_wait", 0.1)
        self.backlog_cap = getattr(conf, "replication_backlog", 1 << 16)
        self.standby_cap = getattr(conf, "replication_standby_keys", 1 << 16)
        # owner-side: key -> (algo, limit, duration) of the last decided
        # request (the request params back stored-duration gaps on
        # backends whose rows don't persist duration)
        self._dirty: Dict[str, Tuple[int, int, int]] = {}
        # takeover-side: keys this node served in another owner's stead
        # (handback candidates), same value shape as _dirty
        self._taken: Dict[str, Tuple[int, int, int]] = {}
        # receiver-side standby table: key -> Snapshot, LRU-bounded,
        # consulted ONLY on takeover (standby_pop)
        self._standby: "Dict[str, Snapshot]" = {}
        self._event = asyncio.Event()
        self._tasks: list = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if not self._tasks:
            from gubernator_tpu_torch.serve.global_mgr import supervise

            self._tasks = [
                asyncio.ensure_future(
                    supervise("replication", self._run_flush)
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
        """Graceful-drain flush (Server.drain step): ship whatever is
        dirty NOW to successors, and attempt one handback round, so a
        SIGTERMed owner's freshest windows survive it."""
        await self.flush_once()

    @property
    def standby_len(self) -> int:
        return len(self._standby)

    @property
    def backlog_len(self) -> int:
        """Dirty owned keys + takeover-tracked keys awaiting the next
        flush — the scrape-time replication_backlog_entries gauge
        (r16), against the GUBER_REPLICATION_BACKLOG bound."""
        return len(self._dirty) + len(self._taken)

    # -- owner-side queueing (hot path: two dict ops) -----------------------

    def queue_dirty(self, r: RateLimitReq) -> None:
        """Mark an owned, hit-carrying token-bucket key dirty for the
        next snapshot flush. Peeks change nothing (nothing to
        replicate); leaky buckets are out of scope (module docstring)."""
        if r.hits <= 0 or r.algorithm != Algorithm.TOKEN_BUCKET:
            return
        key = r.hash_key()
        if key not in self._dirty and len(self._dirty) >= self.backlog_cap:
            self._drop("dirty_backlog")
            return
        self._dirty[key] = (int(r.algorithm), r.limit, r.duration)
        self._event.set()

    def queue_dirty_fields(self, keys, fields, elig=None) -> None:
        """Bridge-tier dirty marking (edge_bridge string->array fold):
        one all-owned folded frame's keys and dense field arrays, same
        gates as queue_dirty. `elig` carries pre-computed
        eligible_field_indices so the bridge screens once per frame
        for every manager. Pre-hashed GEB6/GEB7 frames carry no key
        strings and cannot be marked — a documented scope limit."""
        if elig is None:
            elig = eligible_field_indices(fields)
        if not elig.size:
            return
        limit = fields["limit"]
        duration = fields["duration"]
        dirty = self._dirty
        token = int(Algorithm.TOKEN_BUCKET)
        for i in elig.tolist():
            key = keys[i]
            if key not in dirty and len(dirty) >= self.backlog_cap:
                self._drop("dirty_backlog")
                continue
            dirty[key] = (token, int(limit[i]), int(duration[i]))
        self._event.set()

    def mark_taken(self, r: RateLimitReq) -> None:
        """Record a key this node decided in another owner's stead
        (takeover serve): each flush tick tries to hand its window back
        to the current ring owner."""
        if r.algorithm != Algorithm.TOKEN_BUCKET:
            return
        key = r.hash_key()
        if key not in self._taken and len(self._taken) >= self.backlog_cap:
            self._drop("taken_backlog")
            return
        self._taken[key] = (int(r.algorithm), r.limit, r.duration)
        self._event.set()

    def _drop(self, what: str) -> None:
        try:
            metrics.REPLICATION_DROPPED.labels(what=what).inc()
        except Exception:  # pragma: no cover - defensive
            pass

    # -- receiver-side tables ------------------------------------------------

    def standby_pop(self, key: str) -> Optional[Snapshot]:
        """Take the standby snapshot for a key about to be decided as
        owner/authority — the ONLY reader of the table. Expired rows
        answer None (the first post-reset touch must open a fresh
        window, same rule as the shed cache)."""
        if not self._standby:
            return None
        s = self._standby.pop(key, None)
        if s is None or s.reset_time <= millisecond_now():
            return None
        return s

    async def purge_unsucceeded_standby(self) -> None:
        """Ring-change hygiene (r17 satellite): drop standby rows for
        keys this node neither owns nor succeeds on the CURRENT ring.
        A stale row surviving a reshuffle could seed a WRONG takeover
        window later — e.g. after two membership changes move the
        succession elsewhere and back with a different key split, the
        first touch would install a window frozen at the pre-reshuffle
        state instead of the interim owner's. Called from
        Instance.set_peers after every membership change; the scan is
        two ring lookups per row over a table bounded at 65536, so it
        yields the event loop every chunk rather than stalling every
        in-flight request for the full pass. Rows installed while the
        scan yields are judged against the same (current) ring when
        their chunk comes up, or survive to the next change's pass."""
        if not self._standby:
            return
        picker = self.instance.picker
        for i, key in enumerate(list(self._standby)):
            if i and i % 2048 == 0:
                await asyncio.sleep(0)
            if key not in self._standby:
                continue  # popped/seeded while we yielded
            try:
                if picker.get(key).is_owner:
                    continue  # we own it now: seeded on first touch
                succ = picker.get_successor(key)
                if succ is not None and succ.is_owner:
                    continue  # still the takeover target
            except Exception:  # pragma: no cover - ring flap
                continue
            self._standby.pop(key, None)
            self._drop("standby_reshuffle")

    def standby_purge(self, keys) -> None:
        """Drop standby rows for these keys: an UpdatePeerGlobals
        install means their owner is alive and broadcasting — its
        authoritative status supersedes any replicated snapshot (the
        r10 invalidation stance, applied to the standby table)."""
        if not self._standby:
            return
        for k in keys:
            self._standby.pop(k, None)

    async def install(self, owner: str, snaps: List[Snapshot]) -> None:
        """ReplicateBuckets receive path. Snapshots for keys this node
        OWNS (reconcile handback) install straight into the local store
        — through Instance.update_peer_globals, so the shed cache is
        purged exactly as for a GLOBAL broadcast; snapshots for other
        keys become standby rows, last-write-wins by
        (reset_time, snapshot_ms) so duplicates and retries no-op."""
        now = millisecond_now()
        store_installs: List[Snapshot] = []
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
                store_installs.append(s)
                continue
            cur = self._standby.get(s.key)
            if cur is not None and (
                (cur.reset_time, cur.snapshot_ms)
                >= (s.reset_time, s.snapshot_ms)
            ):
                continue
            # pop-then-insert so dict order tracks install FRESHNESS:
            # at capacity the evictee must be the stalest snapshot, not
            # the first-ever-inserted key (which under steady
            # re-replication is exactly the hottest one)
            self._standby.pop(s.key, None)
            self._standby[s.key] = s
            while len(self._standby) > self.standby_cap:
                self._standby.pop(next(iter(self._standby)))
                self._drop("standby_evict")
        if store_installs:
            await self.instance.update_peer_globals(
                [(s.key, snapshot_resp(s)) for s in store_installs]
            )
            resc = getattr(self.instance, "rescale", None)
            if resc is not None:
                # installed windows are live local state the rescale
                # manager must hand off on the NEXT ring change (r17)
                for s in store_installs:
                    resc.note_installed(s.key, s.limit, s.duration)
            # the handback restored owner state: count + stamp lag
            try:
                metrics.REPLICATION_RECONCILES.inc(len(store_installs))
            except Exception:  # pragma: no cover - defensive
                pass
            self._set_lag(now, store_installs)
            log.info(
                "reconciled %d bucket(s) handed back by '%s'",
                len(store_installs), owner,
            )

    def note_seeded(self, seeds: List[Tuple[str, Snapshot]]) -> None:
        """Account a takeover seed batch (Instance popped the rows and
        installed them before deciding)."""
        try:
            metrics.REPLICATED_TAKEOVERS.inc(len(seeds))
        except Exception:  # pragma: no cover - defensive
            pass
        self._set_lag(millisecond_now(), [s for _, s in seeds])

    def _set_lag(self, now: int, snaps: List[Snapshot]) -> None:
        try:
            lag_ms = max(now - s.snapshot_ms for s in snaps)
            metrics.REPLICATION_LAG.set(max(0.0, lag_ms / 1000.0))
        except Exception:  # pragma: no cover - defensive
            pass

    # -- flush loop ----------------------------------------------------------

    async def _run_flush(self) -> None:
        while True:
            if not self._dirty and not self._taken:
                await self._event.wait()
            # coalesce one window's worth of decides per snapshot
            # (GlobalManager's sync-wait shape); this is also the
            # handback retry tick while an owner is unreachable
            await asyncio.sleep(self.sync_wait)
            self._event.clear()
            await self.flush_once()

    async def flush_once(self) -> None:
        dirty, self._dirty = self._dirty, {}
        owned: Dict[str, Tuple[int, int, int]] = {}
        for key, meta in dirty.items():
            try:
                if self.instance.get_peer(key).is_owner:
                    owned[key] = meta
                else:
                    # ownership moved between decide and flush: treat
                    # like a takeover serve and hand the window to the
                    # new owner below
                    self._taken.setdefault(key, meta)
            except Exception:
                # ring flap (empty/rebuilding picker): re-queue for the
                # next tick instead of losing the window silently; past
                # the cap the loss is at least accounted
                if (
                    key not in self._dirty
                    and len(self._dirty) >= self.backlog_cap
                ):
                    self._drop("dirty_backlog")
                else:
                    self._dirty.setdefault(key, meta)
                    self._event.set()
                continue
        if owned:
            await self._replicate_owned(owned)
        if self._taken:
            await self._handback()

    async def _replicate_owned(
        self, owned: Dict[str, Tuple[int, int, int]]
    ) -> None:
        """Snapshot-read owned dirty keys and ship each to its ring
        successor (skipping keys without a distinct successor).

        Successors resolve AFTER the snapshot await, against the ring
        as it stands at send time (r17 satellite): a membership change
        landing while the device gather is in flight used to leave this
        flush shipping a whole window's worth of dirty keys to the
        PRE-change successor — which the reshuffle may have demoted to
        a bystander whose stale standby row could seed a wrong takeover
        later (see purge_unsucceeded_standby). Pinned by the
        ring-flip-mid-flush test in tests/test_rescale.py."""
        if self.instance.picker.size() <= 1:
            # single-host ring: no key has a distinct successor, so
            # don't pay the serialized device gather every tick only
            # to discard every row at the successor screen below
            return
        snaps = await self._snapshot(list(owned.items()))
        by_peer: Dict[str, List[Snapshot]] = {}
        clients = {}
        for s in snaps:
            try:
                if not self.instance.get_peer(s.key).is_owner:
                    # ownership moved while the gather was in flight:
                    # the window belongs to the new owner now — route
                    # it through the handback path next tick instead
                    # of seeding the wrong successor's standby table
                    self._taken.setdefault(s.key, owned[s.key])
                    self._event.set()
                    continue
                succ = self.instance.picker.get_successor(s.key)
            except Exception as e:  # pragma: no cover - defensive
                log.error(
                    "while finding successor for '%s': %s", s.key, e
                )
                continue
            if succ is None or succ.is_owner:
                continue
            by_peer.setdefault(succ.host, []).append(s)
            clients[succ.host] = succ
        for host, chunk in by_peer.items():
            await self._send(clients[host], chunk)

    async def _handback(self) -> None:
        """Try to return interim windows to their current ring owner.
        Failures (owner still down, breaker open) keep the keys for the
        next tick; the attempt itself doubles as a breaker probe.

        Owners resolve AFTER the snapshot await (the same
        ring-flip-mid-flush rule as _replicate_owned): a rescale
        landing mid-gather must not hand a window to the PRE-change
        owner."""
        taken = dict(self._taken)
        snaps = await self._snapshot(list(taken.items()))
        alive = {s.key: s for s in snaps}
        for key in taken:
            if key not in alive:  # nothing left to hand back (expired)
                self._taken.pop(key, None)
        by_peer: Dict[str, List[Snapshot]] = {}
        clients = {}
        for key, s in alive.items():
            try:
                owner = self.instance.get_peer(key)
            except Exception:
                continue
            if owner.is_owner:
                # the ring moved the key to US: it is a normally owned
                # key now, covered by queue_dirty on its next decide
                self._taken.pop(key, None)
                continue
            by_peer.setdefault(owner.host, []).append(s)
            clients[owner.host] = owner
        for host, chunk in by_peer.items():
            if await self._send(clients[host], chunk, what="handback"):
                for s in chunk:
                    self._taken.pop(s.key, None)

    async def _snapshot(
        self, metas: List[Tuple[str, Tuple[int, int, int]]]
    ) -> List[Snapshot]:
        return await snapshot_windows(self.instance, metas)

    async def _send(self, peer, snaps: List[Snapshot], what="replicate"):
        """One peer's snapshots, chunked under the peer batch cap.
        Returns True when every chunk was delivered."""
        start = time.monotonic()
        advertise = self.conf.resolved_advertise()
        lim = self.conf.behaviors.global_batch_limit
        ok = True
        for i in range(0, len(snaps), lim):
            chunk = snaps[i : i + lim]
            try:
                await peer.replicate_buckets(chunk, owner=advertise)
                try:
                    metrics.REPLICATION_SNAPSHOTS_SENT.inc(len(chunk))
                except Exception:  # pragma: no cover - defensive
                    pass
            except Exception as e:
                ok = False
                log.log(
                    # a failing handback is EXPECTED for the whole
                    # outage (it retries every tick until the owner
                    # returns); don't spam warnings for it
                    logging.DEBUG if what == "handback" else logging.WARNING,
                    "error sending %s snapshots to '%s': %s",
                    what, peer.host, e,
                )
        log.debug(
            "%s: %d snapshot(s) -> %s in %.1f ms%s",
            what, len(snaps), peer.host,
            (time.monotonic() - start) * 1e3,
            "" if ok else " (failed)",
        )
        return ok
