"""Host-side over-limit shed cache: answer sticky verdicts before the device.

The port's copy of gubernator_tpu/serve/shedcache.py with its imports
rewritten; the file references below are the reference package's.

Under the Zipf workloads the ROADMAP targets, the keys that dominate
traffic are exactly the ones sitting over limit — and the token-bucket
kernel makes their verdict *sticky*: an existing token entry whose
remaining is 0 answers every hit-carrying request with exactly
(OVER_LIMIT, stored_limit, remaining=0, stored_reset_time) and mutates
nothing until the window expires (kernels.py decide_presorted: rem_vis
== 0 forces the OVER branch; the writeback re-stores identical values;
oracle.token_bucket's `remaining == 0` path is the same fixed point).
Today every one of those hits still pays the full enqueue -> prep ->
merge -> dispatch -> device round trip. This module is the standard
scalable-rate-limiter move (Raghavan et al., arXiv:2602.11741): a tiny
bounded host cache of those frozen verdicts, consulted BEFORE a request
enters the batcher, absorbing the hot head of the skew.

Shedding is gated to the cases where the cached verdict is provably
byte-identical to what the device would return:

- token bucket only — a leaky bucket refills continuously, so its
  OVER_LIMIT verdict (and reset_time = now + rate) changes every
  millisecond and must never be shed;
- `hits > 0` only — peeks are read-only probes and always reach the
  device (they are also how the GLOBAL broadcast loop peeks status);
- request limit/duration must equal the cached window's params — the
  stores never rewrite an existing window's params (kernels.py
  new_limit/new_duration; oracle keeps the cached resp), so an entry
  created under other params is answered by the device from the STORED
  params and the mismatched request must go see it;
- `now < reset_time` — the first post-reset hit must reach the device
  (it recreates the window there).

Population is device-authoritative: only a device/oracle response with
status == OVER_LIMIT and remaining == 0 whose params echo the request's
inserts an entry; any other response for a cached fingerprint DROPS it
(an under-limit or param-drifted response proves the cached window is
gone — recreated, evicted, or algorithm-switched). Invalidation:

- entries lazily expire at `reset_time`, compared against the same
  unix-ms clock the engines feed their EpochClock (decide converts
  engine-ms responses back with the identical epoch arithmetic, so the
  unix-domain comparison is exactly the device's `g_exp >= now` check);
- a `generation` check against the engine's reset counter
  (core/engine.py reset_generation) clears the whole cache when the
  engine wipes its store (clock jump past the rebase envelope);
- `purge()` is called for every key an UpdatePeerGlobals install or
  update_globals broadcast touches (serve/instance.py), so GLOBAL mode
  cannot serve a stale verdict after an owner-side reset;
- a LEAKY request for a cached fingerprint drops the entry when its
  response is observed (algorithm switch recreates the window).

Accepted staleness (documented, bounded by the original window): an
entry EVICTED from the device store by way pressure, or recreated by
another NODE's algorithm-switch traffic, keeps shedding OVER_LIMIT
until its reset_time — the fail-closed direction for a rate limiter,
and the same over-admission-adjacent envelope the store's eviction
counters already flag.

Thread model: event-loop confined like the rest of the serving tier
(the bridge and instance both consult from the loop); the only
cross-thread reader is the /metrics scrape, which reads plain ints.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    RateLimitResp,
    Status,
    millisecond_now,
    over_limit_resp,
)
from gubernator_tpu_torch.core.algorithms import ALGO_TOKEN, SHEDDABLE_ALGOS

# r15 interplay audit: every consult and populate path below is gated
# on Algorithm.TOKEN_BUCKET because the frozen-verdict fixed point this
# cache serves exists ONLY there — a leaky reset_time refills
# continuously, a sliding blend's weight decays every millisecond, and
# a GCRA TAT drains every millisecond, so none of their OVER verdicts
# is provably current after the response that produced it. This pin
# keeps the registry (core/algorithms.py SHEDDABLE_ALGOS) and this
# module from drifting apart: marking a new algorithm sheddable there
# without teaching lookup/screen_fields/_observe_one its fixed point
# fails at import, not silently in production.
assert SHEDDABLE_ALGOS == {ALGO_TOKEN}, (
    "shed cache only understands the token bucket's frozen verdicts; "
    "extend serve/shedcache.py before marking another algorithm "
    "sheddable in core/algorithms.py"
)

#: default LRU bound (GUBER_SHED_CACHE_KEYS): sized to the hot head a
#: Zipf workload can keep over limit at once, not the whole key space
DEFAULT_KEYS = 1 << 16

#: rough per-entry host footprint (OrderedDict node + uint64 key + the
#: 3-int tuple) used by the boot-time lint, measured on CPython 3.10
ENTRY_BYTES = 200

#: per-call bound on observe_fields' population walk (uncached frozen
#: verdicts); correctness rows (cached fingerprints) are never capped
OBSERVE_INSERT_CAP = 512


def footprint_mib(keys: int) -> float:
    return keys * ENTRY_BYTES / (1 << 20)


def lint_footprint(keys: int, store_capacity: int = 0) -> str:
    """Boot-time sizing lint, the shed-cache sibling of the store
    sizing pass (core/store.check_store_budget): returns a warning
    string ('' = fine). The cache holds only the over-limit head, so a
    bound beyond the store's own entry capacity can never be used."""
    if store_capacity and keys > store_capacity:
        return (
            f"GUBER_SHED_CACHE_KEYS={keys} exceeds the store's entry "
            f"capacity ({store_capacity}); the shed cache mirrors "
            f"store-resident over-limit windows, so the excess "
            f"({footprint_mib(keys - store_capacity):.0f} MiB) can "
            f"never hold a live verdict — lower it"
        )
    if footprint_mib(keys) > 512:
        return (
            f"GUBER_SHED_CACHE_KEYS={keys} ~ {footprint_mib(keys):.0f} "
            f"MiB of host memory for shed verdicts; the cache only "
            f"needs to cover the over-limit HEAD of the key "
            f"distribution, not the key space"
        )
    return ""


class ShedCache:
    """Bounded LRU of frozen token-bucket over-limit verdicts.

    Keys are the uint64 slot-hash fingerprints the device store is
    addressed by (core/hashing.slot_hash_batch) — shared between the
    instance tier (which hashes key strings once per batch anyway) and
    the bridge tier (whose fast frames arrive pre-hashed)."""

    def __init__(
        self,
        capacity: int = DEFAULT_KEYS,
        now_fn=millisecond_now,
        generation_fn=None,
    ):
        self.capacity = max(1, int(capacity))
        self.now_fn = now_fn
        # engine reset counter (backend.shed_generation); None = the
        # backend never wholesale-resets (exact backend)
        self.generation_fn = generation_fn
        self._gen = generation_fn() if generation_fn is not None else 0
        # fingerprint -> (limit, duration, reset_time_unix_ms)
        self._entries: "OrderedDict[int, Tuple[int, int, int]]" = (
            OrderedDict()
        )
        # vectorized-screen snapshot (sorted key/limit/duration/reset
        # arrays), rebuilt lazily after any mutation: the bridge
        # screens thousand-item frames, and per-item dict probes from
        # a Python loop measured ~1.4 ms/frame on a throttled 2-core
        # box — a searchsorted against a sorted snapshot is ~30 us.
        # Under steady over-limit load the entry set barely changes,
        # so rebuilds (O(entries)) are rare.
        self._snap = None
        # monotonic counters (ints: GIL-atomic, scrape reads them raw)
        self.hits = 0
        self.lookups = 0

    # -- lifecycle -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        # an EMPTY cache must not read as "no cache": len() above would
        # otherwise make `if shed:` silently skip population
        return True

    def refresh_generation(self) -> None:
        """Clear everything when the engine wiped its store (EpochClock
        reset_required -> engine.reset()): every cached verdict pointed
        at state that no longer exists. One int compare per screen."""
        if self.generation_fn is None:
            return
        g = self.generation_fn()
        if g != self._gen:
            self._gen = g
            self._entries.clear()
            self._snap = None

    def purge(self, fingerprints) -> None:
        """Drop entries for these uint64 fingerprints (GLOBAL installs:
        the owner's broadcast replaced the replica, so the cached
        verdict is no longer provably current)."""
        for h in fingerprints:
            if self._entries.pop(int(h), None) is not None:
                self._snap = None

    def purge_all(self) -> None:
        self._entries.clear()
        self._snap = None

    def reset_counters(self) -> None:
        """Zero the hit/lookup counters (entries stay live) — the
        profiler scopes measurement windows with
        /v1/debug/stages?reset=1, and per-window hit rates need the
        same scoping."""
        self.hits = 0
        self.lookups = 0

    def stats(self) -> dict:
        lk = self.lookups
        return dict(
            entries=len(self._entries),
            capacity=self.capacity,
            hits=self.hits,
            lookups=lk,
            hit_rate=round(self.hits / lk, 4) if lk else 0.0,
            generation=self._gen,
        )

    # -- consult -------------------------------------------------------------

    def lookup(
        self, h: int, limit: int, duration: int, now: Optional[int] = None
    ) -> Optional[int]:
        """reset_time for a sheddable verdict, or None. The caller has
        already gated algorithm == TOKEN_BUCKET and hits > 0; this
        checks entry existence, param match, and expiry. A param
        mismatch is a MISS, not a drop — the mismatched request goes to
        the device, and its response drops the entry only if the stored
        window really drifted (observe())."""
        self.lookups += 1
        e = self._entries.get(h)
        if e is None:
            return None
        if now is None:
            now = self.now_fn()
        if now >= e[2]:
            # expired: the first post-reset hit must reach the device
            del self._entries[h]
            self._snap = None
            return None
        if e[0] != limit or e[1] != duration:
            return None
        self._entries.move_to_end(h)
        self.hits += 1
        return e[2]

    def lookup_resp(
        self, h: int, req: RateLimitReq, now: Optional[int] = None
    ) -> Optional[RateLimitResp]:
        """Instance-tier consult: the full shed gate over a request
        object. Returns the verdict response (a fresh object — callers
        stamp metadata) or None."""
        if req.hits <= 0 or req.algorithm != Algorithm.TOKEN_BUCKET:
            return None
        reset = self.lookup(h, req.limit, req.duration, now)
        if reset is None:
            return None
        return over_limit_resp(req.limit, reset)

    def _snapshot(self):
        """(keys_sorted u64, limit i64, duration i64, reset i64) of
        the live entries, rebuilt lazily after mutations — the
        vectorized screen's lookup table."""
        import numpy as np

        snap = self._snap
        if snap is None:
            m = len(self._entries)
            keys = np.fromiter(self._entries.keys(), np.uint64, m)
            vals = np.fromiter(
                (v for e in self._entries.values() for v in e),
                np.int64, 3 * m,
            ).reshape(m, 3)
            order = np.argsort(keys)
            snap = self._snap = (
                keys[order],
                vals[order, 0],
                vals[order, 1],
                vals[order, 2],
            )
        return snap

    def screen_fields(self, fields: Dict, now: Optional[int] = None):
        """Bridge-tier consult over one frame's dense arrays
        (key_hash/hits/limit/duration/algo[/gnp]). Returns None when
        nothing sheds, else (shed_mask bool[n], (status, limit,
        remaining, reset) int64[n] with the shed rows filled; residue
        rows are zero and overwritten by the device results).

        Fully vectorized — one searchsorted against the sorted entry
        snapshot plus elementwise gates — so a thousand-item frame
        screens in tens of microseconds of event-loop time (the
        per-item dict-probe loop this replaced measured ~1.4 ms/frame
        on a throttled 2-core host, which ate the shed's own win).
        Two deliberate approximations vs lookup(): screen hits do not
        refresh LRU recency (entries refresh on insert; with the
        bound sized to the over-limit head that's ample), and expired
        entries are skipped, not deleted (lookup()/observe/insert
        pressure prunes them)."""
        import numpy as np

        if not self._entries:
            return None
        if now is None:
            now = self.now_fn()
        kh = np.asarray(fields["key_hash"], np.uint64)
        keys_s, lim_s, dur_s, reset_s = self._snapshot()
        idx = np.searchsorted(keys_s, kh)
        idx[idx == keys_s.shape[0]] = 0
        found = keys_s[idx] == kh
        eligible = (
            (np.asarray(fields["algo"]) == int(Algorithm.TOKEN_BUCKET))
            & (np.asarray(fields["hits"]) > 0)
        )
        gnp = fields.get("gnp")
        if gnp is not None:
            # replica reads answer from the live replica entry;
            # screening them here would skip the replica-miss
            # local-processing path — leave them to the device
            eligible &= ~np.asarray(gnp, bool)
        limit = np.asarray(fields["limit"], np.int64)
        mask = (
            found
            & eligible
            & (lim_s[idx] == limit)
            & (dur_s[idx] == np.asarray(fields["duration"], np.int64))
            & (now < reset_s[idx])
        )
        shed = int(mask.sum())
        self.lookups += int(eligible.sum())
        self.hits += shed
        if not shed:
            return None
        status = np.where(
            mask, int(Status.OVER_LIMIT), 0
        ).astype(np.int64)
        limit_out = np.where(mask, limit, 0)
        remaining = np.zeros(kh.shape[0], np.int64)
        reset_out = np.where(mask, reset_s[idx], 0)
        return mask, (status, limit_out, remaining, reset_out)

    # -- populate / invalidate ----------------------------------------------

    def seed(
        self,
        h: int,
        limit: int,
        duration: int,
        reset_time: int,
        now: Optional[int] = None,
    ) -> None:
        """Promoter feed (r13, serve/promoter.py): install a frozen
        verdict for a hot key whose PROMOTION just wrote an over-limit
        token window (remaining=0, sticky over, this reset_time) into
        the device store — the cached verdict matches store state by
        construction, the same authority as observing the device's own
        response. Expired seeds are ignored."""
        if now is None:
            now = self.now_fn()
        if now >= reset_time:
            return
        entries = self._entries
        if entries.get(h) != (limit, duration, reset_time):
            self._snap = None
        entries[int(h)] = (int(limit), int(duration), int(reset_time))
        entries.move_to_end(int(h))
        if len(entries) > self.capacity:
            entries.popitem(last=False)

    def _observe_one(
        self,
        h: int,
        req_hits: int,
        req_limit: int,
        req_duration: int,
        req_algo: int,
        r_status: int,
        r_limit: int,
        r_remaining: int,
        r_reset: int,
        now: int,
    ) -> None:
        if req_algo != int(Algorithm.TOKEN_BUCKET):
            # a leaky request recreates a stored token window
            # (algorithm switch, kernels.py mismatch path): whatever we
            # cached for this fingerprint no longer exists
            if self._entries.pop(h, None) is not None:
                self._snap = None
            return
        frozen = (
            r_status == int(Status.OVER_LIMIT) and r_remaining == 0
        )
        if frozen and r_limit == req_limit and now < r_reset:
            # the frozen fixed point: stored remaining is 0 and sticky,
            # and every same-param hit until r_reset echoes this exact
            # response (module docstring)
            entries = self._entries
            if entries.get(h) != (req_limit, req_duration, r_reset):
                self._snap = None
            entries[h] = (req_limit, req_duration, r_reset)
            entries.move_to_end(h)
            if len(entries) > self.capacity:
                entries.popitem(last=False)
            return
        e = self._entries.get(h)
        if e is None:
            return
        if frozen and r_limit == e[0] and r_reset == e[2]:
            # the response ECHOES the cached window (the device answers
            # an existing window's hits with the STORED limit, so a
            # param-mismatched request confirms the entry rather than
            # disproving it — dropping here would let mixed-param
            # traffic thrash the cache on exactly the hottest keys)
            return
        # a response that contradicts the cached window (under limit,
        # different stored params, different reset) proves it is gone —
        # reset, evicted, or rewritten
        del self._entries[h]
        self._snap = None

    def observe_resps(
        self,
        fingerprints: Sequence[int],
        reqs: Sequence[RateLimitReq],
        resps: Sequence[RateLimitResp],
        now: Optional[int] = None,
    ) -> None:
        """Object-path population (instance tier): one device/owner
        response per request. Error and degraded responses are skipped
        entirely — they carry no authoritative window state."""
        if now is None:
            now = self.now_fn()
        for h, r, resp in zip(fingerprints, reqs, resps):
            if resp.error or resp.metadata.get("degraded"):
                continue
            self._observe_one(
                int(h), r.hits, r.limit, r.duration, int(r.algorithm),
                int(resp.status), resp.limit, resp.remaining,
                resp.reset_time, now,
            )

    def observe_fields(
        self, fields: Dict, results, now: Optional[int] = None
    ) -> None:
        """Array-path population (bridge tier): `results` is the
        (status, limit, remaining, reset) tuple the batcher resolved
        for exactly these `fields` rows. The walk is bounded: every
        row touching a CACHED fingerprint is visited (confirm / drop /
        leaky pop — the correctness rows, pre-filtered with one
        vectorized snapshot membership test), while frozen-verdict
        rows for UNCACHED fingerprints — pure population — are capped
        at OBSERVE_INSERT_CAP per call, so an over-limit-heavy frame
        whose key cardinality exceeds the cache bound cannot drag a
        ~1 ms/frame Python walk into steady state (the cost the
        vectorized screen exists to avoid)."""
        import numpy as np

        status, limit_r, remaining, reset = results
        sa = np.asarray(status)
        ra = np.asarray(remaining)
        frozen = (sa == int(Status.OVER_LIMIT)) & (ra == 0)
        kh = np.asarray(fields["key_hash"], np.uint64)
        if self._entries:
            keys_s = self._snapshot()[0]
            pos = np.searchsorted(keys_s, kh)
            pos[pos == keys_s.shape[0]] = 0
            cached = keys_s[pos] == kh
        else:
            cached = np.zeros(kh.shape[0], bool)
        must = np.flatnonzero(cached)
        ins = np.flatnonzero(frozen & ~cached)
        if ins.shape[0] > OBSERVE_INSERT_CAP:
            ins = ins[:OBSERVE_INSERT_CAP]
        if not must.shape[0] and not ins.shape[0]:
            return
        # a key's rows all land on one side of the cached split, and
        # flatnonzero keeps row order within each side, so last-wins
        # semantics per key survive the concat
        if now is None:
            now = self.now_fn()
        hits = fields["hits"]
        limit = fields["limit"]
        duration = fields["duration"]
        algo = fields.get("algo")
        limit_a = np.asarray(limit_r)
        reset_a = np.asarray(reset)
        token = int(Algorithm.TOKEN_BUCKET)
        for i in np.concatenate([must, ins]).tolist():
            self._observe_one(
                int(kh[i]), int(hits[i]), int(limit[i]),
                int(duration[i]),
                int(algo[i]) if algo is not None else token,
                int(sa[i]), int(limit_a[i]), int(ra[i]),
                int(reset_a[i]), now,
            )
