"""Device-resident rate-limit state: the slot store (PyTorch port of
gubernator_tpu.core.store).

State is ONE dense int32 tensor of shape [buckets, ways*LANES] on the
device, byte for byte the JAX package's layout: each key hashes to one
bucket of `ways` set-associative entries plus a 32-bit fingerprint tag,
a bucket is one row, and lookup/writeback move whole bucket rows. The
lane meanings, flag bits and int32 time envelope are the reference's
(gubernator_tpu/core/store.py:1-106) and are copied here unchanged.

PyTorch idiom: the store is a plain tensor that the decide updates IN
PLACE (JAX donates the buffer instead), and every constructor takes an
explicit `device`.

Key hashes are uint64 on the wire but torch cannot right-shift uint64,
so the port carries them as int64 BIT PATTERNS: multiply, xor and and
wrap exactly as they do on uint64, and every right shift is made
logical by masking off the sign-extended high bits (`_srl`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from gubernator_tpu_torch.core import hashing

# lane indices
L_TAG = 0
L_EXPIRE = 1
L_REMAINING = 2
L_TS = 3
L_LIMIT = 4
L_DURATION = 5
L_FLAGS = 6
L_KEYLOW = 7
LANES = 8

# flags lane bits
FLAG_STICKY_OVER = 1  # token window created over-limit: status persists OVER
FLAG_ALGO_LEAKY = 2  # slot holds leaky-bucket state (else token bucket)
FLAG_ALGO_SLIDING = 4  # sliding-window counter (per-key anchored windows)
FLAG_ALGO_GCRA = 8  # GCRA: L_EXPIRE holds the theoretical arrival time
FLAG_ALGO_MASK = FLAG_ALGO_LEAKY | FLAG_ALGO_SLIDING | FLAG_ALGO_GCRA

# Engine-time envelope. `now` stays in [0, REBASE_AT]; stored times stay in
# [TIME_FLOOR, INT32_MAX]; durations are clamped to MAX_DURATION_MS so
# now + duration never exceeds int32 range (2^30 + 2^30 - 1 = INT32_MAX).
MAX_DURATION_MS = (1 << 30) - 1  # ~12.4 days
TIME_FLOOR = -(1 << 29)
REBASE_AT = 1 << 30
COUNTER_MAX = (1 << 31) - 1

DENSE_LANES = 128
SLOTS_PER_DENSE_ROW = DENSE_LANES // LANES  # 16

BYTES_PER_ENTRY = LANES * 4  # one packed int32 entry = 32 bytes

MAX_LOAD = 0.68

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Asking for nothing on a host without a GPU is an error, not
    a silent fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gubernator_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class StoreConfig:
    """Capacity knobs: `slots` buckets of `rows` set-associative ways
    each (rows * slots entries)."""

    rows: int = 16  # ways per bucket (set associativity)
    slots: int = 1 << 15  # buckets

    def __post_init__(self):
        if self.rows not in (1, 2, 4, 8, 16):
            raise ValueError("rows (ways) must be 1, 2, 4, 8 or 16")
        if self.slots <= 0 or (self.slots & (self.slots - 1)) != 0:
            raise ValueError("slots must be a power of two")
        if (self.rows * self.slots) % SLOTS_PER_DENSE_ROW != 0:
            raise ValueError(
                "total capacity must be a multiple of 16 for the dense view"
            )


class Store(NamedTuple):
    """The packed state: one int32[buckets, ways*LANES] tensor, updated
    in place by the decide."""

    data: torch.Tensor


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def derive_store_config(
    target_keys: int = 0, mib: int = 0, rows: int = 16
) -> StoreConfig:
    """Store geometry from an operator budget: exactly one of
    `target_keys` (smallest power-of-two capacity with load under
    MAX_LOAD) or `mib` (largest power-of-two slot count whose footprint
    fits). GUBER_STORE_MIB=1024 derives 2^21 buckets x 16 ways."""
    if (target_keys > 0) == (mib > 0):
        raise ValueError(
            "derive_store_config needs exactly one of target_keys / mib"
        )
    if target_keys > 0:
        entries = int(target_keys / MAX_LOAD) + 1
        slots = _pow2_at_least(-(-entries // rows))
    else:
        entries = (mib << 20) // BYTES_PER_ENTRY
        if entries < rows:
            raise ValueError(
                f"store budget {mib} MiB holds fewer than one bucket of "
                f"{rows} ways ({rows * BYTES_PER_ENTRY} bytes)"
            )
        slots = 1 << ((entries // rows).bit_length() - 1)
    slots = max(slots, SLOTS_PER_DENSE_ROW)
    return StoreConfig(rows=rows, slots=slots)


def new_store(
    config: StoreConfig = StoreConfig(), device: DeviceLike = None
) -> Store:
    return Store(
        data=torch.zeros(
            (config.slots, config.rows * LANES),
            dtype=torch.int32,
            device=resolve_device(device),
        )
    )


def store_from_numpy(data: np.ndarray, device: DeviceLike = None) -> Store:
    """A store on `device` holding the bytes of an int32[buckets, W]
    array (e.g. a JAX engine's store fetched to the host)."""
    arr = np.ascontiguousarray(data)
    if arr.dtype != np.int32 or arr.ndim != 2 or arr.shape[1] % LANES:
        raise ValueError(
            f"store array must be int32[buckets, ways*{LANES}], got "
            f"{arr.dtype}{list(arr.shape)}"
        )
    return Store(data=torch.from_numpy(arr).to(resolve_device(device)))


def store_to_numpy(store: Store) -> np.ndarray:
    """The store's bytes as a host int32[buckets, W] array."""
    return store.data.cpu().numpy()


_REBASE_CHUNK_ROWS = 1 << 16


def _rebase_rows(rows: torch.Tensor, delta: int) -> torch.Tensor:
    W = rows.shape[-1]
    lane = torch.arange(W, device=rows.device) % LANES
    is_expire = lane == L_EXPIRE
    is_ts = lane == L_TS
    # broadcast each entry's flags across its 8 lanes so the L_TS
    # decision reads them elementwise
    flags = (
        rows.view(-1, W // LANES, LANES)[..., L_FLAGS : L_FLAGS + 1]
        .expand(-1, W // LANES, LANES)
        .reshape(-1, W)
    )
    ts_is_count = (flags & FLAG_ALGO_SLIDING) != 0
    is_time = is_expire | (is_ts & ~ts_is_count)
    shifted = torch.clamp(
        rows.to(torch.int64) - torch.where(is_time, delta, 0),
        TIME_FLOOR,
        COUNTER_MAX,
    ).to(torch.int32)
    return torch.where(is_time, shifted, rows)


def rebase(store: Store, delta: int) -> Store:
    """Shift all stored times by -delta IN PLACE (the host moved the
    epoch forward by `delta` ms); runs every ~12 days of engine uptime.
    Flag-aware like the reference: L_TS is a time for token, leaky and
    GCRA entries but a COUNT for sliding-window entries, left alone.
    Walks the store in row chunks so the int64 widening never holds a
    copy of the whole table."""
    data = store.data
    delta = int(delta)
    for s in range(0, data.shape[0], _REBASE_CHUNK_ROWS):
        rows = data[s : s + _REBASE_CHUNK_ROWS]
        rows.copy_(_rebase_rows(rows, delta))
    return store


def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_MIX_M1 = _i64(0xBF58476D1CE4E5B9)
_MIX_M2 = _i64(0x94D049BB133111EB)
_BUCKET_SALT = 0x9E3779B97F4A7C15
_BUCKET_SALT_I64 = _i64(_BUCKET_SALT)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch's >> on int64 is
    arithmetic; the mask clears the sign-extended bits)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns of uint64 hashes."""
    x = (x ^ _srl(x, 30)) * _MIX_M1
    x = (x ^ _srl(x, 27)) * _MIX_M2
    return x ^ _srl(x, 31)


def low32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor, bitcast to int32."""
    lo = x & 0xFFFFFFFF
    return torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)


def bucket_index(key_hash: torch.Tensor, buckets: int) -> torch.Tensor:
    """[B] int32 owning bucket for int64-bit-pattern key hashes [B]."""
    return (mix64(key_hash ^ _BUCKET_SALT_I64) & (buckets - 1)).to(
        torch.int32
    )


def fingerprints(key_hash: torch.Tensor) -> torch.Tensor:
    """Nonzero int32 tags [B]: the high 32 bits of each hash, 0 mapped
    to 1, bitcast to int32."""
    fp = _srl(key_hash, 32)
    return low32(torch.where(fp == 0, 1, fp))


def key_hash_tensor(
    key_hash: np.ndarray, device: Optional[torch.device] = None
) -> torch.Tensor:
    """uint64 numpy key hashes as an int64 tensor of the same bits."""
    kh = np.ascontiguousarray(key_hash, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(kh).to(device or "cpu")


def group_sort_key_np(key_hash: np.ndarray, buckets: int) -> np.ndarray:
    """uint64 (bucket << 32 | fingerprint) for presorting batches on the
    host (engine.pad_request_sorted). Must stay bit-identical to the
    tensor pair (bucket_index, fingerprints)."""
    kh = np.asarray(key_hash, np.uint64)
    mixed = hashing.mix64(kh ^ np.uint64(_BUCKET_SALT))
    bkt = mixed & np.uint64(buckets - 1)
    fp = (kh >> np.uint64(32)).astype(np.uint64)
    fp = np.where(fp == 0, np.uint64(1), fp)
    return (bkt << np.uint64(32)) | fp
