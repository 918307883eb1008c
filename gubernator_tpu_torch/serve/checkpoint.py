"""Cluster-wide checkpoint/restore: quota state that survives a fleet.

Everything this repo grew for availability so far assumes SOMEONE
stays alive: r11 replication snapshots owned windows to ring
successors, r17 rescale hands state to new owners on membership
change. A full-fleet restart — power event, kernel patch rebooting
every node, a blue-green cutover that replaces the whole deployment —
has no survivor to hand to, so every over-limit window in the cluster
resets and the abusive traffic the limits were holding back gets a
free window (the "quota amnesia" failure mode; the reference
Gubernator accepts it by design). This module closes that last gap
with the machinery the repo already trusts:

- A supervised CheckpointManager (the GlobalManager/Replication/
  Rescale shape: event-loop confined, `supervise()` restart-on-crash)
  periodically captures quota state OFF the hot path and streams it
  to local disk (GUBER_CHECKPOINT_DIR):

  * tracked-key rows: the r11/r17 owner-side tracked set (bounded by
    GUBER_CHECKPOINT_TRACK_KEYS, freshest-kept) snapshot-read through
    the ONE non-mutating gather replication and rescale use
    (replication.snapshot_windows — device backends on the batcher's
    serialized submit thread). String-keyed, so the rows are
    wire-exportable (blue-green below) and exact-backend friendly.
  * full store lanes: on device backends the engine's export_windows
    dump rides along — EVERY live entry (token, leaky, sliding, GCRA,
    chain-level rows) with raw duration/ts/flags lanes, so restore is
    byte-exact for every algorithm and needs no key strings.

- The on-disk format is torn-write safe: chunk files written
  tmp+fsync+rename with a CRC32 each, then a manifest (format
  version, snapshot stamp, chunk list) written the same way LAST, and
  the directory fsynced. A reader either sees a complete checkpoint
  or the previous one; a half-written chunk fails its CRC and the
  boot falls back COLD, loudly (checkpoint_failures_total{what}),
  never wedged. A manifest from a FUTURE format version is refused
  the same way (version skew during a rolling upgrade must not guess).

- Boot-time warm restore (Server._start_inner, right after
  instance.start()): gated by a staleness bound
  (GUBER_CHECKPOINT_MAX_AGE_MS) — a checkpoint older than the bound
  is worthless (every window it holds would have expired or deserves
  a fresh start) and restoring it would only delay boot; it boots
  cold and counts checkpoint_failures_total{what="stale"}. Fresh
  checkpoints install through the SAME paths live traffic uses:
  string rows through Instance.update_peer_globals (which purges the
  shed cache and standby/pending tables for those keys — a restored
  OVER window can never be shadowed by a pre-restart cached verdict),
  lanes through engine.install_windows on the batcher's submit
  thread, followed by the same shed purge for their hashes. Restore
  re-hashes keys under the CURRENT ring and store geometry, so a
  GUBER_SHARDS change across the restart is just a re-partition
  (parallel/sharded.py install_windows routes by hash).

- Blue-green import (GUBER_CHECKPOINT_EXPORT_PEERS): a fleet being
  replaced streams its tracked windows to the REPLACEMENT fleet's
  doors over the existing ReplicateBuckets RPC — no new RPC, no new
  wire format. Batches carry owner="import:<advertise>" so receivers
  route them here regardless of their repl/rescale knobs; rows the
  receiver does not own under ITS ring forward ONCE to their owner as
  owner="importfwd:<advertise>" (forwarded batches are never
  re-forwarded — loop-free by construction), and still-unowned rows
  park in a bounded LWW pending table the flush loop re-ships and the
  first owned decide seeds (rescale's pending discipline). Installs
  are last-write-wins by (reset_time, snapshot_ms), so duplicate
  delivery — export every interval PLUS a final drain export — is a
  no-op, and the old fleet can keep serving while the new one warms.

- Drain (Server.drain) flushes a final checkpoint + export, so a
  SIGTERM'd fleet leaves state at most ONE in-flight request stale
  rather than one interval stale.

Deliberate scope:

- With a healthy fleet, checkpointing ON is byte-identical to OFF:
  the capture surfaces are non-mutating and the writes happen in a
  worker thread (tests/test_checkpoint.py pins it differentially —
  exact, single-device, mesh).
- The staleness/loss bound is one checkpoint interval
  (GUBER_CHECKPOINT_INTERVAL_MS) + write time; the restored state is
  at-least-as-restrictive as the pre-kill windows within that bound
  (remaining can only be over-counted by hits lost in the last
  interval — the fail-closed direction for an over-limit key).
- Wire export is token-bucket windows (the r11 Snapshot scope); the
  on-disk lanes section covers every algorithm locally.

The port's copy of gubernator_tpu/serve/checkpoint.py with its imports
rewritten; the file references above are the reference package's.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import zlib
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    millisecond_now,
)
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.faults import FAULTS
from gubernator_tpu_torch.serve.replication import Snapshot, snapshot_resp

log = logging.getLogger("gubernator_tpu_torch.checkpoint")

#: on-disk format version. Readers refuse anything NEWER than this
#: (cold boot + checkpoint_failures_total{what="version"}) — a rolled-
#: back binary must never misparse a new fleet's checkpoint silently.
FORMAT_VERSION = 1

MANIFEST = "manifest.json"

#: rough per-window on-disk footprint (JSON row + chunk overhead), for
#: the boot-time sizing log and the docs sizing math
ENTRY_DISK_BYTES = 120

#: snapshot rows per chunk file: bounds the blast radius of one torn
#: write and keeps each file's parse cheap
CHUNK_ROWS = 4096

#: full-lane columns, serialization order (matches export_windows)
LANE_COLS = (
    "key_hash", "limit", "remaining", "reset_time",
    "duration", "ts", "flags",
)


class CheckpointError(Exception):
    """A checkpoint that exists but cannot be used. `kind` is the
    checkpoint_failures_total label: 'read' (I/O), 'corrupt' (CRC/
    parse/count mismatch — torn write), 'version' (future format)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def disk_footprint_mib(windows: int) -> float:
    return windows * ENTRY_DISK_BYTES / (1 << 20)


# -- blocking file I/O (asyncio.to_thread from the manager) ------------------


def _fsync_write(path: str, data: bytes) -> None:
    """Torn-write-safe single file: tmp + fsync + atomic rename. A
    crash mid-write leaves the previous content (or a stray .tmp the
    next write replaces), never a half-file under the real name."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(dirpath: str) -> None:
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - platform-dependent
        pass


def write_checkpoint(
    dirpath: str,
    snaps: List[Snapshot],
    lanes: Optional[dict],
    advertise: str,
    snapshot_ms: int,
) -> None:
    """One complete checkpoint under `dirpath` (blocking; call in a
    worker thread). Chunks first, manifest LAST — the manifest names
    every chunk with its CRC, so a reader sees either this checkpoint
    whole or the previous one. Raises on any I/O failure (the manager
    counts it; the previous checkpoint stays valid)."""
    os.makedirs(dirpath, exist_ok=True)
    chunk_meta: List[dict] = []
    for idx in range((len(snaps) + CHUNK_ROWS - 1) // CHUNK_ROWS):
        rows = [list(s) for s in snaps[idx * CHUNK_ROWS:(idx + 1) * CHUNK_ROWS]]
        data = json.dumps({"rows": rows}, separators=(",", ":")).encode()
        name = f"chunk-{idx:04d}.json"
        _fsync_write(os.path.join(dirpath, name), data)
        chunk_meta.append({
            "file": name,
            "crc": zlib.crc32(data) & 0xFFFFFFFF,
            "count": len(rows),
        })
    lane_meta: List[dict] = []
    lane_count = 0
    if lanes is not None and len(lanes.get("key_hash", ())):
        n = len(lanes["key_hash"])
        cols = {c: [int(v) for v in lanes[c]] for c in LANE_COLS}
        for idx, start in enumerate(range(0, n, CHUNK_ROWS)):
            part = {c: cols[c][start:start + CHUNK_ROWS] for c in LANE_COLS}
            data = json.dumps(
                {"cols": part}, separators=(",", ":")
            ).encode()
            name = f"lanes-{idx:04d}.json"
            _fsync_write(os.path.join(dirpath, name), data)
            lane_meta.append({
                "file": name,
                "crc": zlib.crc32(data) & 0xFFFFFFFF,
                "count": len(part["key_hash"]),
            })
            lane_count += len(part["key_hash"])
    manifest = {
        "format_version": FORMAT_VERSION,
        "advertise": advertise,
        "snapshot_ms": int(snapshot_ms),
        "windows": len(snaps),
        "lane_windows": lane_count,
        "chunks": chunk_meta,
        "lane_chunks": lane_meta,
    }
    _fsync_write(
        os.path.join(dirpath, MANIFEST),
        json.dumps(manifest, indent=1).encode(),
    )
    # chunks beyond this checkpoint's set belonged to an earlier,
    # larger one: the new manifest no longer references them
    keep = {m["file"] for m in chunk_meta} | {m["file"] for m in lane_meta}
    for fn in os.listdir(dirpath):
        if (
            (fn.startswith("chunk-") or fn.startswith("lanes-"))
            and fn.endswith(".json")
            and fn not in keep
        ):
            try:
                os.remove(os.path.join(dirpath, fn))
            except OSError:  # pragma: no cover - races a concurrent rm
                pass
    _fsync_dir(dirpath)


def read_checkpoint(
    dirpath: str,
) -> Optional[Tuple[dict, List[Snapshot], Optional[dict]]]:
    """Read and verify one checkpoint (blocking; worker thread).
    Returns None when no manifest exists (a fresh node — cold boot, no
    failure), (manifest, snaps, lanes|None) on success, and raises
    CheckpointError (kind: read/corrupt/version) for a checkpoint that
    exists but cannot be trusted."""
    mpath = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as e:
        raise CheckpointError("read", f"manifest unreadable: {e}")
    except ValueError as e:
        raise CheckpointError("corrupt", f"manifest unparsable: {e}")
    ver = manifest.get("format_version")
    if not isinstance(ver, int) or ver < 1:
        raise CheckpointError(
            "corrupt", f"manifest format_version {ver!r} is not valid"
        )
    if ver > FORMAT_VERSION:
        raise CheckpointError(
            "version",
            f"checkpoint format v{ver} is newer than this binary's "
            f"v{FORMAT_VERSION} (rolling upgrade skew?) — refusing to "
            "guess at its layout",
        )

    def chunk_bytes(m: dict) -> bytes:
        p = os.path.join(dirpath, m["file"])
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError as e:
            raise CheckpointError("read", f"chunk {m['file']}: {e}")
        if (zlib.crc32(data) & 0xFFFFFFFF) != m["crc"]:
            raise CheckpointError(
                "corrupt",
                f"chunk {m['file']}: CRC mismatch (torn write?)",
            )
        return data

    snaps: List[Snapshot] = []
    for m in manifest.get("chunks", []):
        data = chunk_bytes(m)
        try:
            rows = json.loads(data)["rows"]
        except (ValueError, KeyError, TypeError) as e:
            raise CheckpointError("corrupt", f"chunk {m['file']}: {e}")
        if len(rows) != m.get("count"):
            raise CheckpointError(
                "corrupt", f"chunk {m['file']}: row count mismatch"
            )
        for r in rows:
            snaps.append(Snapshot(
                str(r[0]), int(r[1]), int(r[2]), int(r[3]),
                int(r[4]), int(r[5]), int(r[6]), int(r[7]),
            ))
    lanes: Optional[dict] = None
    lane_meta = manifest.get("lane_chunks", [])
    if lane_meta:
        cols: Dict[str, list] = {c: [] for c in LANE_COLS}
        for m in lane_meta:
            data = chunk_bytes(m)
            try:
                part = json.loads(data)["cols"]
            except (ValueError, KeyError, TypeError) as e:
                raise CheckpointError(
                    "corrupt", f"lane chunk {m['file']}: {e}"
                )
            if len(part.get("key_hash", ())) != m.get("count"):
                raise CheckpointError(
                    "corrupt",
                    f"lane chunk {m['file']}: row count mismatch",
                )
            for c in LANE_COLS:
                if c not in part:
                    raise CheckpointError(
                        "corrupt",
                        f"lane chunk {m['file']}: missing column {c!r}",
                    )
                cols[c].extend(part[c])
        lanes = cols
    return manifest, snaps, lanes


# -- the manager -------------------------------------------------------------


class CheckpointManager:
    """Supervised periodic checkpoint loop + restore/import receiver.

    Event-loop confined like the other serve-tier managers; the only
    cross-thread work is the device gathers/installs (the batcher's
    single submit thread, the r11 contract) and the file I/O
    (asyncio.to_thread — a slow or hung disk never blocks serving)."""

    def __init__(self, conf, instance):
        self.conf = conf
        self.instance = instance
        self.dir = getattr(conf, "checkpoint_dir", "") or ""
        self.sync_wait = getattr(conf, "checkpoint_interval", 5.0)
        self.max_age = getattr(conf, "checkpoint_max_age", 300.0)
        self.track_cap = getattr(conf, "checkpoint_track_keys", 1 << 16)
        self.export_peers: List[str] = list(
            getattr(conf, "checkpoint_export_peers", ()) or ()
        )
        # owner-side: key -> (algo, limit, duration) of the last decide
        # (duration backfill, the r11 Snapshot convention);
        # freshest-kept at capacity via pop-then-insert
        self._tracked: Dict[str, Tuple[int, int, int]] = {}
        # receiver-side: imported/restored rows this node does not own
        # YET, LWW by (reset_time, snapshot_ms); re-shipped to ring
        # owners by the flush loop, popped on the first owned decide
        self._pending: Dict[str, Snapshot] = {}
        # lazy PeerClients for the blue-green export targets (these
        # doors are NOT ring members — they are the replacement fleet)
        self._export_clients: Dict[str, object] = {}
        # unix-ms stamp of the last successful write (or the restored
        # manifest's stamp at boot); the checkpoint_age_seconds basis
        self.last_ok_ms = 0
        self._event = asyncio.Event()
        self._tasks: list = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if not self._tasks:
            from gubernator_tpu_torch.serve.global_mgr import supervise

            self._tasks = [
                asyncio.ensure_future(
                    supervise("checkpoint", self._run_flush)
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
        for c in self._export_clients.values():
            try:
                await c.close()
            except Exception:  # pragma: no cover - defensive
                pass
        self._export_clients = {}

    async def drain(self) -> None:
        """Final flush on planned shutdown (Server.drain): the state
        on disk — and on the replacement fleet, in a blue-green — is
        then at most one in-flight request stale, not one interval."""
        try:
            await self.flush_once()
        except Exception as e:  # pragma: no cover - drain must not fail
            log.warning("checkpoint: drain flush failed: %s", e)

    @property
    def age_seconds(self) -> Optional[float]:
        if not self.last_ok_ms:
            return None
        return max(0.0, (millisecond_now() - self.last_ok_ms) / 1000.0)

    @property
    def tracked_len(self) -> int:
        return len(self._tracked)

    @property
    def pending_len(self) -> int:
        return len(self._pending)

    # -- owner-side tracking (hot path: dict ops only) ----------------------

    def note_owned(self, r: RateLimitReq) -> None:
        """Track an owned, hit-carrying token-bucket key as holding a
        live window worth checkpointing (the r11/r17 eligibility rule;
        peeks cannot create windows). Non-token windows are covered by
        the full-lane store dump, which needs no tracking."""
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
        for k, s in seeds:
            self.note_installed(k, s.limit, s.duration)

    def note_installed(self, key: str, limit: int, duration: int) -> None:
        self._note_key(
            key, (int(Algorithm.TOKEN_BUCKET), int(limit), int(duration))
        )

    def _note_key(self, key: str, meta: Tuple[int, int, int]) -> None:
        tracked = self._tracked
        prev = tracked.pop(key, None)
        if prev is None and len(tracked) >= self.track_cap:
            tracked.pop(next(iter(tracked)))
            self._fail("track_evict")
        tracked[key] = meta

    # -- receiver side ------------------------------------------------------

    async def install(self, owner: str, snaps: List[Snapshot]) -> None:
        """ReplicateBuckets receive fallback (repl and rescale both
        off): the same two-way owned/pending split rescale provides,
        against this manager's pending table."""
        await self._split_install(owner, snaps, forward=False)

    async def install_import(self, owner: str, snaps: List[Snapshot]) -> None:
        """A blue-green import batch (owner carries the import:/
        importfwd: marker). Owned rows install; non-owned rows of a
        FIRST-delivery batch (import:) forward once to their owner
        under this ring; rows of an already-forwarded batch
        (importfwd:) — or rows whose forward fails — park in the
        pending table for the flush loop to re-ship. One forwarding
        hop maximum: loop-free however the two rings disagree."""
        forward = owner.startswith("import:")
        await self._split_install(owner, snaps, forward=forward)

    async def _split_install(
        self, owner: str, snaps: List[Snapshot], forward: bool
    ) -> None:
        now = millisecond_now()
        installs: List[Snapshot] = []
        by_host: Dict[str, Tuple] = {}
        for s in snaps:
            if (
                s.reset_time <= now
                or s.algorithm != int(Algorithm.TOKEN_BUCKET)
            ):
                continue
            peer = None
            try:
                peer = self.instance.get_peer(s.key)
                we_own = peer.is_owner
            except Exception:
                # no ring yet (boot-time restore, single node): this
                # node IS the whole ring
                we_own = True
            if we_own:
                installs.append(s)
            elif forward and peer is not None:
                entry = by_host.get(peer.host)
                if entry is None:
                    by_host[peer.host] = (peer, [s])
                else:
                    entry[1].append(s)
            else:
                self._park(s)
        if installs:
            await self._install_snaps(installs, what=owner)
        if by_host:
            fwd_owner = f"importfwd:{self.conf.resolved_advertise()}"
            lim = self.conf.behaviors.global_batch_limit
            for host, (peer, group) in by_host.items():
                for i in range(0, len(group), lim):
                    chunk = group[i:i + lim]
                    try:
                        await peer.replicate_buckets(
                            chunk, owner=fwd_owner
                        )
                    except Exception as e:
                        # park instead of drop: the flush loop retries
                        for s in chunk:
                            self._park(s)
                        log.warning(
                            "checkpoint: import forward to '%s' "
                            "failed (%s); parked %d row(s)",
                            host, e, len(chunk),
                        )

    async def _install_snaps(
        self, snaps: List[Snapshot], what: str
    ) -> None:
        """Install owned snapshots through Instance.update_peer_globals
        — the ONE replica-install path, so the shed-cache purge and
        standby/pending supersession fire exactly as for an owner
        broadcast (a restored OVER window is never shadowed by a
        pre-restart cached verdict). Tracks every row here and in the
        sibling managers (live state to replicate/hand off/checkpoint
        next round)."""
        inst = self.instance
        lim = self.conf.behaviors.global_batch_limit
        now = millisecond_now()
        for i in range(0, len(snaps), lim):
            chunk = snaps[i:i + lim]
            await inst.update_peer_globals(
                [(s.key, snapshot_resp(s)) for s in chunk]
            )
            seeds = [(s.key, s) for s in chunk]
            self.note_seeded(seeds)
            if inst.repl is not None:
                inst.repl.note_seeded(seeds)
            if inst.rescale is not None:
                inst.rescale.note_seeded(seeds)
        try:
            metrics.RESTORED_WINDOWS.inc(len(snaps))
            lag_ms = max(now - s.snapshot_ms for s in snaps)
            metrics.RESTORE_LAG.set(max(0.0, lag_ms / 1000.0))
        except Exception:  # pragma: no cover - defensive
            pass
        log.info(
            "checkpoint: installed %d window(s) (%s)", len(snaps), what
        )

    def _park(self, s: Snapshot) -> None:
        cur = self._pending.get(s.key)
        if cur is not None and (
            (cur.reset_time, cur.snapshot_ms)
            >= (s.reset_time, s.snapshot_ms)
        ):
            return
        self._pending.pop(s.key, None)
        self._pending[s.key] = s
        while len(self._pending) > self.track_cap:
            self._pending.pop(next(iter(self._pending)))
            self._fail("pending_evict")

    def pending_pop(self, key: str) -> Optional[Snapshot]:
        """Take the parked snapshot for a key about to be decided as
        owner — the first owned touch after an import/restore landed
        here before the ring agreed. Expired rows answer None (the
        first post-reset touch must open a fresh window)."""
        if not self._pending:
            return None
        s = self._pending.pop(key, None)
        if s is None or s.reset_time <= millisecond_now():
            return None
        return s

    def pending_purge(self, keys) -> None:
        """An UpdatePeerGlobals install supersedes parked rows for
        these keys (the r11 standby rule applied here)."""
        if not self._pending:
            return
        for k in keys:
            self._pending.pop(k, None)

    # -- boot-time restore --------------------------------------------------

    async def restore(self) -> int:
        """Warm restore from GUBER_CHECKPOINT_DIR (Server boot, after
        instance.start()). Every failure path boots COLD and loudly —
        a checkpoint problem must never wedge a boot: missing manifest
        is a fresh node (no failure counted); stale/corrupt/future-
        version checkpoints count checkpoint_failures_total{what} and
        return 0. Returns the number of windows restored."""
        if not self.dir:
            return 0
        try:
            if FAULTS.enabled:
                await FAULTS.inject("checkpoint_read")
            doc = await asyncio.to_thread(read_checkpoint, self.dir)
        except CheckpointError as e:
            self._fail(e.kind)
            log.error(
                "checkpoint: restore from %r failed (%s): %s — "
                "booting cold", self.dir, e.kind, e,
            )
            return 0
        except Exception as e:
            self._fail("read")
            log.error(
                "checkpoint: restore from %r failed: %s — booting "
                "cold", self.dir, e,
            )
            return 0
        if doc is None:
            log.info(
                "checkpoint: no checkpoint in %r — cold boot", self.dir
            )
            return 0
        manifest, snaps, lanes = doc
        now = millisecond_now()
        age_ms = now - int(manifest.get("snapshot_ms", 0))
        if self.max_age > 0 and age_ms > self.max_age * 1000.0:
            self._fail("stale")
            log.error(
                "checkpoint: %r is %.1fs old, past "
                "GUBER_CHECKPOINT_MAX_AGE_MS (%.0fs) — booting cold",
                self.dir, age_ms / 1000.0, self.max_age,
            )
            return 0
        restored = 0
        lanes_installed = await self._restore_lanes(lanes, now)
        restored += lanes_installed
        live = [s for s in snaps if s.reset_time > now]
        if lanes_installed:
            # the lanes dump carried every live entry byte-exact
            # (including these token rows); re-installing the string
            # rows through update_globals would zero their duration
            # lane. Use them for TRACKING only — plus the shed purge
            # the lanes install already did by hash.
            seeds = [(s.key, s) for s in live]
            self.note_seeded(seeds)
            inst = self.instance
            if inst.repl is not None:
                inst.repl.note_seeded(seeds)
            if inst.rescale is not None:
                inst.rescale.note_seeded(seeds)
        elif live:
            await self._split_install(
                f"restore:{self.dir}", live, forward=False
            )
            restored += len(live)
        self.last_ok_ms = int(manifest.get("snapshot_ms", now))
        try:
            metrics.RESTORE_LAG.set(max(0.0, age_ms / 1000.0))
            if lanes_installed:
                metrics.RESTORED_WINDOWS.inc(lanes_installed)
        except Exception:  # pragma: no cover - defensive
            pass
        log.warning(
            "checkpoint: restored %d window(s) from %r "
            "(age %.1fs, %d tracked row(s), %d lane row(s))",
            restored, self.dir, age_ms / 1000.0, len(live),
            lanes_installed,
        )
        return restored

    async def _restore_lanes(
        self, lanes: Optional[dict], now: int
    ) -> int:
        """Byte-exact full-store reinstall on engine backends: the
        lanes columns land through install_windows on the batcher's
        submit thread (routes by hash under the CURRENT ShardingPolicy
        — restore across a GUBER_SHARDS change is a re-partition),
        then the shed cache purges those hashes, the same
        invalidation update_peer_globals performs for string keys."""
        if not lanes or not lanes.get("key_hash"):
            return 0
        eng = getattr(self.instance.backend, "engine", None)
        if eng is None or not hasattr(eng, "install_windows"):
            return 0
        import numpy as np

        live = [
            i for i, rt in enumerate(lanes["reset_time"]) if rt > now
        ]
        if not live:
            return 0
        cols = {
            c: np.asarray(
                [lanes[c][i] for i in live],
                np.uint64 if c == "key_hash" else np.int64,
            )
            for c in LANE_COLS
        }

        def _do_install():
            eng.install_windows(
                cols["key_hash"], cols["limit"], cols["remaining"],
                cols["reset_time"], None, now=now,
                duration=cols["duration"], ts=cols["ts"],
                flags=cols["flags"],
            )

        await self.instance.batcher.run_serialized(_do_install)
        if self.instance.shed is not None:
            self.instance.shed.purge(cols["key_hash"])
        return len(live)

    # -- flush loop ---------------------------------------------------------

    async def _run_flush(self) -> None:
        while True:
            try:
                await asyncio.wait_for(
                    self._event.wait(), timeout=self.sync_wait
                )
                self._event.clear()
            except asyncio.TimeoutError:
                pass
            await self.flush_once()

    def kick(self) -> None:
        """Wake the flush loop now (tests, drain helpers)."""
        self._event.set()

    async def flush_once(self) -> int:
        """One checkpoint round: gather tracked rows (+ the engine
        lanes dump), write to disk in a worker thread, export to the
        blue-green targets, re-ship parked rows. Any failure counts
        and leaves the previous checkpoint intact. Returns the number
        of tracked rows captured."""
        metas = dict(self._tracked)
        from gubernator_tpu_torch.serve.replication import snapshot_windows

        snaps = await snapshot_windows(self.instance, list(metas.items()))
        now = millisecond_now()
        if self.dir:
            try:
                if FAULTS.enabled:
                    await FAULTS.inject("checkpoint_write")
                lanes = await self._gather_lanes(now)
                await asyncio.to_thread(
                    write_checkpoint, self.dir, snaps, lanes,
                    self.conf.resolved_advertise(), now,
                )
                self.last_ok_ms = now
                try:
                    metrics.CHECKPOINT_AGE.set(0.0)
                except Exception:  # pragma: no cover - defensive
                    pass
            except Exception as e:
                self._fail("write")
                log.warning(
                    "checkpoint: write to %r failed: %s", self.dir, e
                )
        if self.export_peers and snaps:
            await self._export(snaps)
        if self._pending:
            await self._reship_pending()
        return len(snaps)

    async def _gather_lanes(self, now: int) -> Optional[dict]:
        """The engine's full-store dump (non-mutating; submit-thread
        contract), None on backends without one (exact)."""
        eng = getattr(self.instance.backend, "engine", None)
        fn = getattr(eng, "export_windows", None)
        if fn is None:
            return None
        w = await self.instance.batcher.run_serialized(fn, now)
        if not w["key_hash"].shape[0]:
            return None
        return {c: w[c] for c in LANE_COLS}

    # -- blue-green export --------------------------------------------------

    def _export_client(self, host: str):
        c = self._export_clients.get(host)
        if c is None:
            from gubernator_tpu_torch.serve.peers import PeerClient

            c = PeerClient(self.conf.behaviors, host)
            c.connect()
            self._export_clients[host] = c
        return c

    async def _export(self, snaps: List[Snapshot]) -> None:
        """Stream tracked windows to the replacement fleet's doors,
        chunks round-robin across the listed targets (each receiver
        re-routes rows under ITS ring, so any door works for any
        row). LWW installs make every interval's re-send a no-op."""
        lim = self.conf.behaviors.global_batch_limit
        owner = f"import:{self.conf.resolved_advertise()}"
        chunks = [
            snaps[i:i + lim] for i in range(0, len(snaps), lim)
        ]
        for i, chunk in enumerate(chunks):
            host = self.export_peers[i % len(self.export_peers)]
            try:
                peer = self._export_client(host)
                await peer.replicate_buckets(chunk, owner=owner)
            except Exception as e:
                self._fail("export")
                log.warning(
                    "checkpoint: export to '%s' failed: %s", host, e
                )

    async def _reship_pending(self) -> None:
        """Re-route parked rows: rows this node owns NOW install; the
        rest re-ship to their current ring owners (importfwd — the
        receiver parks rather than re-forwards, so a flapping ring
        cannot make a row orbit). Failures keep the row parked for
        the next tick."""
        now = millisecond_now()
        installs: List[Snapshot] = []
        by_host: Dict[str, Tuple] = {}
        for key, s in list(self._pending.items()):
            if s.reset_time <= now:
                self._pending.pop(key, None)
                continue
            try:
                peer = self.instance.get_peer(key)
            except Exception:
                continue
            if peer.is_owner:
                self._pending.pop(key, None)
                installs.append(s)
            else:
                entry = by_host.get(peer.host)
                if entry is None:
                    by_host[peer.host] = (peer, [s])
                else:
                    entry[1].append(s)
        if installs:
            await self._install_snaps(installs, what="pending")
        if by_host:
            fwd_owner = f"importfwd:{self.conf.resolved_advertise()}"
            lim = self.conf.behaviors.global_batch_limit
            for host, (peer, group) in by_host.items():
                for i in range(0, len(group), lim):
                    chunk = group[i:i + lim]
                    try:
                        await peer.replicate_buckets(
                            chunk, owner=fwd_owner
                        )
                    except Exception as e:
                        log.warning(
                            "checkpoint: pending re-ship to '%s' "
                            "failed: %s", host, e,
                        )
                        continue
                    for s in chunk:
                        self._pending.pop(s.key, None)

    @staticmethod
    def _fail(what: str) -> None:
        try:
            metrics.CHECKPOINT_FAILURES.labels(what=what).inc()
        except Exception:  # pragma: no cover - defensive
            pass
