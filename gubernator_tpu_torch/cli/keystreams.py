"""Shared key-stream recipes for every bench and scenario (r13).

The zipf key recipe used to live twice — cli/bench_serving.py's zipf10m
scenario and scripts/bench_scenarios.py's r5 sweep each had their own
copy of the same three constants — so one drifted edit would silently
decouple the serving bench from the kernel bench it claims to mirror.
This module is now the single source of truth (both import it, and the
constants are test-pinned), plus the streams the r13 sketch-tier work
needs:

- `zipf` — the canonical heavy-tail workload (a=1.2 over `key_space`
  ids, splitmix-style hashed), bit-identical to the historical recipe
  for any (key_space, size, seed).
- `key-churn` — the adversarial stream from ROADMAP item 4: every
  phase presents an ENTIRELY FRESH key set (sequential ids offset by
  phase), so every recency/frequency structure in the stack — the shed
  cache, the exact tier's slots, the promoter's top-K — is defeated by
  construction. This is the worst case for tier thrash: nothing is ever
  hot twice, every create fights for a way, and the sketch tier absorbs
  the overflow.

Keys are emitted as uint64 slot hashes (the pre-hashed array-door
shape, same as edge GEB6/GEB7 frames); numpy only, jax-free.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: the historical zipf recipe constants — changing any of these breaks
#: comparability with every committed BENCH_* artifact
ZIPF_A = 1.2
MIX_MUL = 0x9E3779B97F4A7C15
MIX_XOR = 0xDEADBEEFCAFEF00D

STREAMS = ("zipf", "key-churn", "flash-crowd")


def hash_ids(ids: np.ndarray) -> np.ndarray:
    """uint64 key hashes from integer key ids — the staging-side twin
    of hashing a key string once (the benches pre-hash like the edge's
    GEB6 frames, outside any timed region)."""
    return (
        np.asarray(ids).astype(np.uint64) * np.uint64(MIX_MUL)
    ) ^ np.uint64(MIX_XOR)


def zipf_ids(
    key_space: int, size, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Zipf(a=1.2) key ids folded into `key_space`; `size` may be an
    int or a shape tuple. Seed 42 is the benches' pinned default."""
    rng = rng or np.random.default_rng(42)
    return rng.zipf(ZIPF_A, size=size) % key_space


def zipf_pool(
    key_space: int, size, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Pre-hashed zipf key pool — the one zipf recipe every scenario
    shares (bench_serving zipf10m/zipf100m, the r5 sweep, the error-
    bound property tests)."""
    return hash_ids(zipf_ids(key_space, size, rng))


def churn_pool(key_space: int, size: int, phase: int = 0) -> np.ndarray:
    """Adversarial key-churn pool: `size` sequential ids starting at
    phase*size (mod key_space). Consecutive phases are disjoint key
    sets until the space wraps — by then the earliest keys' windows are
    long gone, so reuse never becomes locality."""
    ks = np.uint64(max(int(key_space), 1))
    ids = (
        np.arange(size, dtype=np.uint64)
        + np.uint64(int(phase)) * np.uint64(size)
    ) % ks
    return hash_ids(ids)


def flash_crowd_pool(
    key_space: int,
    size: int,
    phase: int = 0,
    crowd: int = 64,
    share: float = 0.8,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Flash-crowd stream (r15): `share` of the traffic hammers a
    `crowd`-sized set of SUDDENLY-hot keys — fresh every phase, so no
    earlier window, shed entry, or promoter rank exists for them when
    the crowd arrives — over the canonical zipf background. The shape
    the sliding-window blend is for: a fixed window admits 2x limit
    around each boundary under this stream, the blend does not."""
    rng = rng or np.random.default_rng(1000 + phase)
    out = zipf_ids(key_space, size, rng)
    is_crowd = rng.random(size) < share
    # crowd ids live in a reserved stripe far above the zipf head and
    # advance by `crowd` each phase: disjoint from the background and
    # from every earlier phase's crowd until the space wraps
    stripe = (1 << 40) + phase * crowd
    out = np.where(
        is_crowd, stripe + rng.integers(0, crowd, size), out
    )
    return hash_ids(out)


def tenant_zipf_ids(
    tenants: int, size: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Tenant draw for the mixed-tenant-zipf chain scenario (r15):
    zipf over `tenants` — a few tenants dominate the front door, the
    long tail trickles, the multi-tenant shape quota chains exist
    for. Returns int64 tenant ids (not hashed: they become chain
    LEVEL keys, strings, serving-side)."""
    rng = rng or np.random.default_rng(43)
    return (rng.zipf(ZIPF_A, size=size) % tenants).astype(np.int64)


def stream_pool(
    name: str,
    key_space: int,
    size: int,
    rng: Optional[np.random.Generator] = None,
    phase: int = 0,
) -> np.ndarray:
    """Named-stream front door for CLI scenarios."""
    if name == "zipf":
        return zipf_pool(key_space, size, rng)
    if name == "key-churn":
        return churn_pool(key_space, size, phase)
    if name == "flash-crowd":
        return flash_crowd_pool(key_space, size, phase)
    raise ValueError(
        f"unknown key stream {name!r} (choose from {STREAMS})"
    )
