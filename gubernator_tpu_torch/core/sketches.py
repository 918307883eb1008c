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
(`_sketch_lookup`). The serving-side observers of the reference module
(HyperLogLog, SpaceSaving, TrafficStats) belong to the serving tier and
are not ported here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

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
) -> Tuple[StoreConfig, Optional[SketchConfig]]:
    """(exact-tier StoreConfig, SketchConfig or None) for one pinned
    GUBER_STORE_MIB budget that covers BOTH tiers: the sketch's footprint
    is carved out first and the exact tier derives from the rest.
    `sketch_mib=0` auto-sizes the sketch at min(256, store_mib // 4); a
    budget too small to carve a quarter from leaves the tier off. An
    explicit sketch budget that leaves nothing for the exact tier is an
    error. Row counts are the defaults (the derivation's sketch rows, 16
    exact-tier ways). GUBER_STORE_MIB=1024 derives a v2 int32[2, 2^25]
    sketch (256 MiB) and an int32[2^20, 128] exact tier (768 MiB
    budget)."""
    if store_mib <= 0:
        raise ValueError("store_mib must be a positive MiB budget")
    skc = None
    if sketch:
        mib = sketch_mib if sketch_mib > 0 else min(256, store_mib // 4)
        if mib >= 1:
            skc = derive_sketch_config(mib, derivation=derivation)
    exact_mib = store_mib
    if skc is not None:
        sk_mib = -(-sketch_footprint_bytes(skc) // (1 << 20))
        exact_mib = store_mib - sk_mib
        if exact_mib <= 0:
            raise ValueError(
                f"the sketch ({sk_mib} MiB) consumes the whole "
                f"{store_mib} MiB budget; leave room for the exact tier"
            )
    return derive_store_config(mib=exact_mib), skc


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
