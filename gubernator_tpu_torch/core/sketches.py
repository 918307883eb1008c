"""The count-min cold tier's geometry and indexing (PyTorch port of the
device half of gubernator_tpu.core.sketches).

The two-tier store keeps a count-min sketch of `rows` hash rows x
`width` counters beside the exact slot store on the device. Every create
the exact tier refuses (way exhaustion, or a victim that is still live)
is decided from the sketch's window-keyed estimate instead, with
conservative update (core.kernels, `decide_presorted_sketch`). The
design, the error bound and the two derivations are the reference's
(gubernator_tpu/core/sketches.py:1-83): "v2" spends the byte budget on 2
rows of saturating int32 counters, "r13" on 4 rows of int64.

What lives here: the salts and the window mix that both the device and
the host index with, `SketchConfig` and its derivation from a MiB
budget, the two-tier carve-out of one MiB budget (`derive_two_tier_config`,
serve/config.py:491-575 in the reference), the zeroed device sketch,
and the numpy twins `window_id_np` / `sketch_indices_np`, which must
stay bit-identical to the device indexing in core.kernels
(`_sketch_lookup`). At the end, the serving-side observers of the
reference module (HyperLogLog, SpaceSaving, TrafficStats; reference
lines 248-494), copied unchanged: the serving Instance keeps a
TrafficStats of the keys it routes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.core import hashing
from gubernator_tpu_torch.core.algorithms import (
    ALGO_GCRA,
    ALGO_LEAKY,
    ALGO_SLIDING,
    ALGO_TOKEN,
    SKETCH_SERVABLE_ALGOS,
)
from gubernator_tpu_torch.core.store import (
    DeviceLike,
    StoreConfig,
    derive_store_config,
    resolve_device,
)

# The decide's sketch branch serves exactly these four algorithms; if the
# registry ever changes, the kernel and this pin change together
# (gubernator_tpu/core/sketches.py:111-117).
if SKETCH_SERVABLE_ALGOS != {ALGO_TOKEN, ALGO_LEAKY, ALGO_SLIDING, ALGO_GCRA}:
    raise ImportError(
        "the sketch tier serves exactly {token, leaky, sliding, gcra}; "
        "update core/kernels.py's sketch branch and this pin together with "
        "core/algorithms.py SKETCH_SERVABLE_ALGOS"
    )

#: per-row index salts (splitmix64-style odd constants); up to 8 rows
SKETCH_SALTS = (
    0x9AE16A3B2F90404F,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
    0x85EBCA6B27D4EB4F,
    0xFF51AFD7ED558CCD,
    0xC4CEB9FE1A85EC53,
    0x2545F4914F6CDD1D,
)

#: window-id mix multiplier: the same key's indices move every window
WINDOW_MIX = 0xD6E8FEB86659FD93

SKETCH_BYTES_PER_COUNTER = 8  # r13 dense int64 rows (the default dtype)

#: derivation -> (default rows, counter bytes)
SKETCH_DERIVATIONS = {
    "v2": (2, 4),
    "r13": (4, SKETCH_BYTES_PER_COUNTER),
}


def _as_i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits (the port holds
    hashes as int64 bit patterns, core.store)."""
    return c - (1 << 64) if c >= 1 << 63 else c


#: the constants above as int64 bit patterns, for the device indexing
SKETCH_SALTS_I64 = tuple(_as_i64(s) for s in SKETCH_SALTS)
WINDOW_MIX_I64 = _as_i64(WINDOW_MIX)


@dataclass(frozen=True)
class SketchConfig:
    """Count-min tier geometry: `rows` hash rows of `width` counters,
    `counter_bytes` wide (8 = int64, 4 = saturating int32). With N
    charged sketch-tier hits in a window, P[estimate - true > e*N/width]
    < e^-rows."""

    rows: int = 4
    width: int = 1 << 19
    counter_bytes: int = SKETCH_BYTES_PER_COUNTER

    def __post_init__(self):
        if not 1 <= self.rows <= len(SKETCH_SALTS):
            raise ValueError(f"sketch rows must be 1..{len(SKETCH_SALTS)}")
        if self.width <= 0 or (self.width & (self.width - 1)) != 0:
            raise ValueError("sketch width must be a power of two")
        if self.counter_bytes not in (4, 8):
            raise ValueError("sketch counters are int32 (4) or int64 (8)")

    @property
    def dtype(self) -> torch.dtype:
        return torch.int32 if self.counter_bytes == 4 else torch.int64


class Sketch(NamedTuple):
    """The cold tier's state: one [rows, width] counter tensor (int32
    under v2, int64 under r13), updated IN PLACE by the decide."""

    data: torch.Tensor


def sketch_footprint_bytes(config: SketchConfig) -> int:
    return config.rows * config.width * config.counter_bytes


def derive_sketch_config(
    mib: int, rows: int = 0, derivation: str = "v2"
) -> SketchConfig:
    """Largest power-of-two width whose rows x width x counter_bytes fits
    in `mib` MiB. `rows=0` takes the derivation's default (v2: 2, r13:
    4); an explicit row count keeps the derivation's counter dtype."""
    if derivation not in SKETCH_DERIVATIONS:
        raise ValueError(
            f"unknown sketch derivation {derivation!r}; "
            f"one of {sorted(SKETCH_DERIVATIONS)}"
        )
    if mib <= 0:
        raise ValueError("sketch budget must be positive MiB")
    default_rows, cbytes = SKETCH_DERIVATIONS[derivation]
    rows = rows or default_rows
    counters = (mib << 20) // (rows * cbytes)
    if counters < 1:
        raise ValueError(f"sketch budget {mib} MiB holds no counters at {rows} rows")
    width = 1 << (counters.bit_length() - 1)
    return SketchConfig(rows=rows, width=width, counter_bytes=cbytes)


def derive_two_tier_config(
    store_mib: int,
    sketch: bool = True,
    sketch_mib: int = 0,
    derivation: str = "v2",
    rows: int = 16,
    sketch_rows: int = 0,
) -> Tuple[StoreConfig, Optional[SketchConfig]]:
    """(exact-tier StoreConfig, SketchConfig or None) for one pinned
    GUBER_STORE_MIB budget that covers BOTH tiers: the sketch's footprint
    is carved out first and the exact tier derives from the rest.
    `sketch_mib=0` auto-sizes the sketch at min(256, store_mib // 4); a
    budget too small to carve a quarter from leaves the tier off. An
    explicit sketch budget that leaves nothing for the exact tier is an
    error. `rows` are the exact tier's ways (GUBER_STORE_ROWS),
    `sketch_rows` the sketch's rows (0 = the derivation's default).
    GUBER_STORE_MIB=1024 derives a v2 int32[2, 2^25] sketch (256 MiB)
    and an int32[2^20, 128] exact tier (768 MiB budget)."""
    if store_mib <= 0:
        raise ValueError("store_mib must be a positive MiB budget")
    skc = None
    if sketch:
        mib = sketch_mib if sketch_mib > 0 else min(256, store_mib // 4)
        if mib >= 1:
            skc = derive_sketch_config(mib, rows=sketch_rows, derivation=derivation)
    exact_mib = store_mib
    if skc is not None:
        sk_mib = -(-sketch_footprint_bytes(skc) // (1 << 20))
        exact_mib = store_mib - sk_mib
        if exact_mib <= 0:
            raise ValueError(
                f"the sketch ({sk_mib} MiB) consumes the whole "
                f"{store_mib} MiB budget; leave room for the exact tier"
            )
    return derive_store_config(mib=exact_mib, rows=rows), skc


def new_sketch(config: SketchConfig, device: DeviceLike = None) -> Sketch:
    """A zeroed sketch on `device` (cuda unless the caller names another)."""
    return Sketch(
        data=torch.zeros(
            (config.rows, config.width),
            dtype=config.dtype,
            device=resolve_device(device),
        )
    )


def window_id_np(engine_now: int, durations: np.ndarray) -> np.ndarray:
    """Fixed-window id per request: engine-ms `now` // duration (floored
    at 1 ms)."""
    d = np.maximum(np.asarray(durations, np.int64), 1)
    return np.asarray(engine_now, np.int64) // d


def sketch_indices_np(
    key_hash: np.ndarray, window_id: np.ndarray, config: SketchConfig
) -> np.ndarray:
    """int64[rows, n] counter index per (key, window): the host twin of
    core.kernels._sketch_lookup (bit-identical, test-pinned). A negative
    window id wraps to uint64 as the device's sign extension does."""
    kh = np.asarray(key_hash, np.uint64)
    wid = np.asarray(window_id, np.int64).view(np.uint64)
    base = hashing.mix64(kh ^ (wid * np.uint64(WINDOW_MIX)))
    out = np.empty((config.rows, kh.shape[0]), np.int64)
    mask = np.uint64(config.width - 1)
    for r in range(config.rows):
        hr = hashing.mix64(base ^ np.uint64(SKETCH_SALTS[r]))
        out[r] = (hr & mask).astype(np.int64)
    return out


# -- serving-side observers (copied from the reference module) ----------------


_ALPHA_INF = 0.721347520444482  # 1 / (2 ln 2)


def _popcount64(x: np.ndarray) -> np.ndarray:
    """SWAR popcount over uint64 (numpy<2 has no bitwise_count)."""
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (x * np.uint64(0x0101010101010101)) >> np.uint64(56)


class HyperLogLog:
    """Fixed-memory distinct-count estimator over uint64 hashes.

    Standard HLL with linear-counting small-range correction; typical
    error ~1.04/sqrt(m) (p=14 -> ~0.8%). Thread-safe.
    """

    def __init__(self, p: int = 14):
        assert 4 <= p <= 18
        self.p = p
        self.m = 1 << p
        self._reg = np.zeros(self.m, np.uint8)
        self._lock = threading.Lock()

    def add_hashes(self, hashes: np.ndarray) -> None:
        """Fold a batch of uint64 key hashes into the registers."""
        if hashes.size == 0:
            return
        if hashes.size <= 16:
            # small-batch fast path: plain ints beat numpy's per-op
            # overhead by ~10x at serving-RPC sizes
            w = 64 - self.p
            with self._lock:
                for v in hashes.tolist():
                    idx = v >> (64 - self.p)
                    rem = (v << self.p) & 0xFFFFFFFFFFFFFFFF
                    rho = 65 - rem.bit_length() if rem else w + 1
                    if rho > self._reg[idx]:
                        self._reg[idx] = rho
            return
        h = hashes.astype(np.uint64, copy=False)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        w = 64 - self.p
        rem = h << np.uint64(self.p)  # remaining bits at the top
        # leading zeros among the w bits via smear + popcount
        x = rem.copy()
        for s in (1, 2, 4, 8, 16, 32):
            x |= x >> np.uint64(s)
        clz = (np.uint64(64) - _popcount64(x)).astype(np.uint8)
        rho = np.where(rem == 0, w + 1, clz + 1).astype(np.uint8)
        with self._lock:
            np.maximum.at(self._reg, idx, rho)

    def estimate(self) -> int:
        with self._lock:
            reg = self._reg.copy()
        m = float(self.m)
        raw = (
            _ALPHA_INF
            * m
            * m
            / float(np.sum(np.exp2(-reg.astype(np.float64))))
        )
        zeros = int(np.count_nonzero(reg == 0))
        if raw <= 2.5 * m and zeros > 0:
            return int(round(m * np.log(m / zeros)))  # linear counting
        return int(round(raw))

    def reset(self) -> None:
        with self._lock:
            self._reg.fill(0)

    def merge(self, other: "HyperLogLog") -> None:
        assert self.p == other.p
        with self._lock, other._lock:
            np.maximum(self._reg, other._reg, out=self._reg)


class SpaceSaving:
    """Top-K heavy hitters with bounded overestimate (stream-summary).

    `observe` pre-aggregates a batch, then folds it in: known keys add
    their weight; unknown keys replace the current minimum (inheriting its
    count as the error bound) once capacity is reached. Thread-safe.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._counts: Dict[str, int] = {}
        self._errs: Dict[str, int] = {}
        # optional per-key payload (the sketch promoter stores the
        # candidate's last-seen (limit, duration) here); evicted with
        # its key, so bounded by `capacity`
        self._payload: Dict = {}
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, keys: List[str]) -> None:
        if not keys:
            return
        agg: Dict[str, int] = {}
        for k in keys:
            agg[k] = agg.get(k, 0) + 1
        self.observe_weighted(agg)

    def observe_weighted(
        self, agg: Dict, payloads: Optional[Dict] = None
    ) -> None:
        """Fold a pre-aggregated {key: weight} batch in (keys may be any
        hashable — the sketch promoter uses uint64 key-hash ints).
        `payloads` optionally records a per-key payload for keys that
        end up tracked (last write wins).

        Replacement runs as a HEAP cascade — one heapify per call plus
        O(log capacity) per evicting insert — instead of the historical
        O(capacity) min-scan per new key, which measured 10x of serving
        throughput away once the r13 promoter hook started folding
        dispatch-sized batches on the submit thread. Semantics are the
        classic per-item cascade's: each new key replaces the CURRENT
        minimum (which may be a key inserted earlier in this same
        call) and inherits its count as the error floor, so an
        established heavy hitter can never be displaced by a flood of
        singletons — the floor only creeps up one weight at a time."""
        if not agg:
            return
        with self._lock:
            self.total += sum(agg.values())
            counts, errs = self._counts, self._errs
            new = []
            for k, w in agg.items():
                if k in counts:
                    counts[k] += w
                    if payloads is not None and k in payloads:
                        self._payload[k] = payloads[k]
                else:
                    new.append((k, w))
            i = 0
            while i < len(new) and len(counts) < self.capacity:
                k, w = new[i]
                counts[k] = w
                errs[k] = 0
                if payloads is not None and k in payloads:
                    self._payload[k] = payloads[k]
                i += 1
            if i < len(new):
                import heapq

                # counts are final for surviving keys at this point, so
                # the heap has exactly one live entry per key; cascade
                # insertions push their own entries back (they may be
                # re-evicted by later new keys, exactly like the
                # per-item original)
                heap = [(c, k) for k, c in counts.items()]
                heapq.heapify(heap)
                for k, w in new[i:]:
                    while True:
                        floor, vk = heapq.heappop(heap)
                        if counts.get(vk) == floor:
                            break  # live entry (defensive: see above)
                    del counts[vk]
                    errs.pop(vk, None)
                    self._payload.pop(vk, None)
                    counts[k] = floor + w
                    errs[k] = floor
                    heapq.heappush(heap, (floor + w, k))
                    if payloads is not None and k in payloads:
                        self._payload[k] = payloads[k]

    def payload(self, key):
        with self._lock:
            return self._payload.get(key)

    def decay(self, shift: int = 1) -> None:
        """Halve (>> shift) every tracked count/err — the streaming
        demotion half of the promoter: without decay a formerly-hot key
        rides its historical count forever and the top-K can never turn
        over under churn. Keys decayed to zero are dropped entirely
        (full demotion)."""
        with self._lock:
            dead = []
            for k in self._counts:
                c = self._counts[k] >> shift
                if c <= 0:
                    dead.append(k)
                else:
                    self._counts[k] = c
                    self._errs[k] = self._errs.get(k, 0) >> shift
            for k in dead:
                del self._counts[k]
                self._errs.pop(k, None)
                self._payload.pop(k, None)

    def top(self, n: int = 20) -> List[Tuple[str, int, int]]:
        """[(key, count, err)] sorted hot-first. count-err is a lower
        bound on the key's true frequency."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: kv[1], reverse=True
            )[:n]
            return [(k, c, self._errs.get(k, 0)) for k, c in items]

    def top_with_payload(self, n: int = 20) -> List[Tuple]:
        """[(key, count, err, payload)] sorted hot-first; payload is
        None for keys observed without one."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: kv[1], reverse=True
            )[:n]
            return [
                (k, c, self._errs.get(k, 0), self._payload.get(k))
                for k, c in items
            ]

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._errs.clear()
            self._payload.clear()
            self.total = 0


class TrafficStats:
    """Per-instance traffic observability: distinct keys + hot keys."""

    def __init__(self, hll_p: int = 14, top_capacity: int = 256):
        self.hll = HyperLogLog(hll_p)
        self.hot = SpaceSaving(top_capacity)

    def observe(self, keys: List[str], hashes: np.ndarray) -> None:
        self.hll.add_hashes(hashes)
        self.hot.observe(keys)

    def observe_hashes(self, hashes: np.ndarray) -> None:
        """Hash-only observation (edge fast path: key strings never
        reach Python). Distinct-key estimation stays exact; hot-key
        NAMES are unavailable for this traffic by design."""
        self.hll.add_hashes(hashes)

    def snapshot(self, top_n: int = 20) -> dict:
        return {
            "distinct_keys_estimate": self.hll.estimate(),
            "observed_total": self.hot.total,
            "hot_keys": [
                {"key": k, "count": c, "max_overestimate": e}
                for k, c, e in self.hot.top(top_n)
            ],
        }
