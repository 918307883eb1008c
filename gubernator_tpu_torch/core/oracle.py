"""Exact rate-limit algorithms over a host cache (the port's copy of
gubernator_tpu/core/oracle.py, on the port's core/algorithms.py).

This is both (a) the exact-semantics serving backend and (b) a differential
oracle for the device decide. Behavior mirrors the
reference's algorithms (reference algorithms.go:24-186) including its
observable quirks:

- OVER_LIMIT responses on the "insufficient remaining" path are NOT persisted,
  so a retry within the window with a smaller hit count can succeed
  (algorithms.go:27-31,57-62).
- A token-bucket window created with hits > limit stores remaining = limit
  with a persisted OVER_LIMIT status ("sticky over"), so subsequent peeks and
  successful decrements keep reporting OVER_LIMIT until the window resets
  (algorithms.go:77-81 + the cached-status reuse at 40-65).
- hits == 0 is a read-only peek (algorithms.go:47-49) — except for the leaky
  bucket, where the empty-bucket check precedes the peek check, so a peek at
  an empty bucket reports OVER_LIMIT (algorithms.go:129-151).
- The leaky bucket advances its timestamp on every non-zero-hit request, even
  refused ones, discarding sub-tick leak remainder (algorithms.go:118-121).
- Leaky responses carry reset_time only on OVER_LIMIT paths (now + rate);
  UNDER_LIMIT leaky responses have reset_time = 0 (algorithms.go:123-174).
- Algorithm switch: a request finding state of the other algorithm removes it
  and recreates as a fresh *token* bucket in both directions — the leaky
  mismatch path also delegates to tokenBucket (algorithms.go:33-38,100-105).

Documented divergences (deliberate, each noted inline):

1. Leaky-bucket cache expiry is set to now + duration on update. The reference
   sets now * duration (algorithms.go:157) — an apparent bug that makes
   entries effectively immortal.
2. Leaky-bucket rate is max(duration // limit, 1) and limit <= 0 returns
   OVER_LIMIT. The reference divides by zero (process crash) when limit == 0
   or duration < limit (algorithms.go:107,111).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.core.algorithms import (
    gcra_params,
    sliding_dur,
    sliding_rotate,
    sliding_used,
)
from gubernator_tpu_torch.core.cache import LRUCache, millisecond_now


@dataclass
class _LeakyState:
    limit: int
    duration: int
    remaining: int
    timestamp: int


@dataclass
class _SlidingState:
    """Sliding-window counter state (r15, core/algorithms.py): per-key
    anchored subwindows — `ws` is the current subwindow's start, `cur`
    its consumed count, `prev` the previous subwindow's. Cache expiry
    is ws + 2*duration (the entry stays useful through the following
    window as its "previous")."""

    limit: int
    duration: int
    ws: int
    cur: int
    prev: int


@dataclass
class _GcraState:
    """GCRA state (r15): one theoretical arrival time. Cache expiry IS
    the TAT — a fully-drained bucket (tat < now) lazily expires, which
    is indistinguishable from fresh state by construction (the same
    contract the device kernel gets from the store's expiry lane)."""

    limit: int
    duration: int
    tat: int


def token_bucket(
    cache: LRUCache, r: RateLimitReq, now: Optional[int] = None
) -> RateLimitResp:
    """Token bucket (reference algorithms.go:24-85)."""
    if now is None:
        now = millisecond_now()

    key = r.hash_key()
    item, ok = cache.get(key, now)
    if ok:
        if not isinstance(item, RateLimitResp):
            # Algorithm switched (leaky -> token): recreate.
            cache.remove(key)
            return token_bucket(cache, r, now)

        rl = item
        if rl.remaining == 0:
            # Persisted mutation: the cached status flips to OVER_LIMIT.
            rl.status = Status.OVER_LIMIT
            return _copy(rl)

        if r.hits == 0:
            return _copy(rl)

        if rl.remaining == r.hits:
            rl.remaining = 0
            return _copy(rl)

        if r.hits > rl.remaining:
            ret = _copy(rl)
            ret.status = Status.OVER_LIMIT
            return ret

        rl.remaining -= r.hits
        return _copy(rl)

    expire = now + r.duration
    status = RateLimitResp(
        status=Status.UNDER_LIMIT,
        limit=r.limit,
        remaining=r.limit - r.hits,
        reset_time=expire,
    )
    if r.hits > r.limit:
        status.status = Status.OVER_LIMIT
        status.remaining = r.limit
    cache.add(key, status, expire)
    return _copy(status)


def leaky_bucket(
    cache: LRUCache, r: RateLimitReq, now: Optional[int] = None
) -> RateLimitResp:
    """Leaky bucket (reference algorithms.go:88-186)."""
    if now is None:
        now = millisecond_now()

    key = r.hash_key()
    item, ok = cache.get(key, now)
    if ok:
        if not isinstance(item, _LeakyState):
            # Algorithm switched (token -> leaky): the reference removes the
            # entry and runs tokenBucket — i.e. the request is served as a
            # freshly created *token* bucket (algorithms.go:100-105).
            cache.remove(key)
            return token_bucket(cache, r, now)

        b = item
        if r.limit <= 0:
            # Divergence 2: the reference divides by zero on this path
            # (algorithms.go:107). Only the existing-state path divides; the
            # mismatch and creation paths never do and are kept faithful.
            return RateLimitResp(
                status=Status.OVER_LIMIT, limit=r.limit, remaining=0,
                reset_time=now + b.duration,
            )
        rate = max(b.duration // r.limit, 1)  # divergence 2 guard

        elapsed = now - b.timestamp
        leak = elapsed // rate
        b.remaining = min(b.remaining + leak, b.limit)

        if r.hits != 0:
            b.timestamp = now

        rl = RateLimitResp(
            status=Status.UNDER_LIMIT, limit=b.limit, remaining=b.remaining
        )

        if b.remaining == 0:
            rl.status = Status.OVER_LIMIT
            rl.reset_time = now + rate
            return rl

        if b.remaining == r.hits:
            # Note: no expiration update here — the reference's exact-drain
            # branch doesn't touch expiry either (algorithms.go:137-141).
            b.remaining = 0
            rl.remaining = 0
            return rl

        if r.hits > b.remaining:
            rl.status = Status.OVER_LIMIT
            rl.reset_time = now + rate
            return rl

        if r.hits == 0:
            return rl

        b.remaining -= r.hits
        rl.remaining = b.remaining
        cache.update_expiration(key, now + b.duration)  # divergence 1
        return rl

    b = _LeakyState(
        limit=r.limit,
        duration=r.duration,
        remaining=r.limit - r.hits,
        timestamp=now,
    )
    rl = RateLimitResp(
        status=Status.UNDER_LIMIT,
        limit=r.limit,
        remaining=r.limit - r.hits,
        reset_time=0,
    )
    if r.hits > r.limit:
        rl.status = Status.OVER_LIMIT
        rl.remaining = 0
        b.remaining = 0
    cache.add(key, b, now + r.duration)
    return rl


def sliding_window(
    cache: LRUCache, r: RateLimitReq, now: Optional[int] = None
) -> RateLimitResp:
    """Sliding-window counter (r15): previous-window weighted blend
    over per-key anchored subwindows. Host twin of the kernel's
    FLAG_ALGO_SLIDING branch — byte-identical through the engine's
    epoch conversion (tests/test_algorithms.py); the shared integer
    conventions live in core/algorithms.py."""
    if now is None:
        now = millisecond_now()

    key = r.hash_key()
    item, ok = cache.get(key, now)
    if ok:
        if not isinstance(item, _SlidingState):
            # Algorithm switched: a sliding request recreates as a
            # fresh SLIDING window (core/algorithms.py mismatch rule —
            # the token/leaky pair keeps the reference's token-recreate
            # behavior; the new algorithms recreate as themselves).
            cache.remove(key)
            return sliding_window(cache, r, now)

        s = item
        d = sliding_dur(s.duration)  # capped period (int32 envelope)
        expire = s.ws + 2 * d
        s.ws, s.cur, s.prev = sliding_rotate(
            expire, s.duration, now, s.cur, s.prev
        )
        used = sliding_used(s.ws, s.duration, now, s.cur, s.prev)
        budget = max(min(s.limit - used, max(s.limit, 0)), 0)

        rl = RateLimitResp(
            status=Status.UNDER_LIMIT,
            limit=s.limit,
            remaining=budget,
            reset_time=s.ws + d,  # current subwindow's end
        )
        if 0 < r.hits <= budget:
            s.cur += r.hits
            rl.remaining = budget - r.hits
        elif r.hits != 0 or budget == 0:
            rl.status = Status.OVER_LIMIT
        # rotation may have advanced the window: persist the new
        # expiry (the kernel re-writes the expire lane every touch)
        cache.update_expiration(key, s.ws + 2 * d)
        return rl

    s = _SlidingState(
        limit=r.limit, duration=r.duration, ws=now, cur=0, prev=0
    )
    rl = RateLimitResp(
        status=Status.UNDER_LIMIT,
        limit=r.limit,
        remaining=r.limit - r.hits,
        reset_time=now + r.duration,
    )
    if r.hits > r.limit:
        # refused creation stores an untouched fresh window (no
        # sticky-over: sliding status is recomputed every call)
        rl.status = Status.OVER_LIMIT
        rl.remaining = r.limit
    elif r.hits > 0:
        s.cur = r.hits
    cache.add(key, s, now + 2 * sliding_dur(r.duration))
    return rl


def gcra(
    cache: LRUCache, r: RateLimitReq, now: Optional[int] = None
) -> RateLimitResp:
    """GCRA (r15): one theoretical arrival time per key, emission
    interval T = duration/limit, burst tolerance tau = T*limit. Host
    twin of the kernel's FLAG_ALGO_GCRA branch (byte-identical;
    conventions in core/algorithms.py). Every touch advances the
    stored TAT to at least `now` (draining is a re-expression of time
    passage, not a mutation of consumed quota)."""
    if now is None:
        now = millisecond_now()

    key = r.hash_key()
    item, ok = cache.get(key, now)
    if ok:
        if not isinstance(item, _GcraState):
            # mismatch rule: GCRA recreates as itself
            cache.remove(key)
            return gcra(cache, r, now)

        s = item
        T, tau = gcra_params(s.limit, s.duration)
        tat0 = max(s.tat, now)
        budget = max(min((now + tau - tat0) // T, max(s.limit, 0)), 0)

        rl = RateLimitResp(
            status=Status.UNDER_LIMIT, limit=s.limit, remaining=budget
        )
        if 0 < r.hits <= budget:
            s.tat = tat0 + r.hits * T
            rl.remaining = budget - r.hits
            rl.reset_time = s.tat
        elif r.hits == 0:
            s.tat = tat0
            if budget == 0:
                rl.status = Status.OVER_LIMIT
            rl.reset_time = tat0
        else:
            # refused: no charge; report the earliest instant this
            # same request could succeed
            s.tat = tat0
            rl.status = Status.OVER_LIMIT
            rl.reset_time = tat0 + r.hits * T - tau
        cache.update_expiration(key, s.tat)
        return rl

    T, _tau = gcra_params(r.limit, r.duration)
    over_c = r.hits > r.limit
    charged = not over_c and r.hits > 0
    tat = now + (r.hits * T if charged else 0)
    rl = RateLimitResp(
        status=Status.OVER_LIMIT if over_c else Status.UNDER_LIMIT,
        limit=r.limit,
        remaining=r.limit if over_c else r.limit - r.hits,
        reset_time=tat,
    )
    cache.add(key, _GcraState(limit=r.limit, duration=r.duration, tat=tat), tat)
    return rl


def get_rate_limit(
    cache: LRUCache, r: RateLimitReq, now: Optional[int] = None
) -> RateLimitResp:
    """Dispatch on algorithm (reference gubernator.go:244-250; the r15
    suite extends the family — core/algorithms.py)."""
    if r.algorithm == Algorithm.TOKEN_BUCKET:
        return token_bucket(cache, r, now)
    if r.algorithm == Algorithm.LEAKY_BUCKET:
        return leaky_bucket(cache, r, now)
    if r.algorithm == Algorithm.SLIDING_WINDOW:
        return sliding_window(cache, r, now)
    if r.algorithm == Algorithm.GCRA:
        return gcra(cache, r, now)
    raise ValueError(f"invalid rate limit algorithm '{r.algorithm}'")


def _copy(rl: RateLimitResp) -> RateLimitResp:
    return RateLimitResp(
        status=rl.status,
        limit=rl.limit,
        remaining=rl.remaining,
        reset_time=rl.reset_time,
        error=rl.error,
        metadata=dict(rl.metadata),
    )
