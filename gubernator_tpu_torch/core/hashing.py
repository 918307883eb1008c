"""Key hashing (the port's copy of gubernator_tpu.core.hashing).

1. Ring hash: crc32 of the key, the reference's consistent-hash point
   (reference hash.go:40-42).
2. Slot hash: a 64-bit hash of the key that picks the store bucket and
   the 32-bit fingerprint tag. It is local to one process, so any
   stable 64-bit hash serves, but one process must use ONE. The batch
   path is native XXH64 (native/guberhash.cc, built with g++ at first
   use, native/hashlib_native.py) when that library builds and loads,
   and blake2b-8 otherwise; a failed build or load logs a WARNING with
   the compiler's output. The selection is made once, lazily, as the
   reference makes it (`_native_batch`, `_native_checked`).

`mix64` here is the numpy splitmix64 finalizer; core.store carries its
torch twin for key hashes held as int64 bit patterns.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Iterable, List

import numpy as np


def ring_hash(key: str) -> int:
    """crc32 point on the ring, matching reference hash.go:40-42."""
    return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF


def _slot_hash_py(key: str) -> int:
    """Pure-Python fallback 64-bit hash (blake2b-8, little-endian)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "little"
    )


def _slot_hash_batch_py(keys: Iterable[str]) -> np.ndarray:
    return np.array([_slot_hash_py(k) for k in keys], dtype=np.uint64)


# The native batch hasher (XXH64) is loaded lazily. Native and fallback
# produce different hash values; that is fine (slot hashes are local to
# one process's store) as long as one process uses ONE implementation,
# which the lazy singleton guarantees.
_native_batch = None
_native_checked = False


def _load_native():
    global _native_batch, _native_checked
    if _native_checked:
        return
    _native_checked = True
    from gubernator_tpu_torch.native import load_hashlib

    hn = load_hashlib()  # logs the WARNING when it cannot build or load
    _native_batch = hn.hash_batch if hn is not None else None


def slot_hash_batch(keys: List[str]) -> np.ndarray:
    """uint64[len(keys)] of slot hashes; native XXH64 when it loads."""
    _load_native()
    if _native_batch is not None:
        return _native_batch(keys)
    return _slot_hash_batch_py(keys)


def using_native_hash() -> bool:
    """True when slot_hash_batch resolves to the native XXH64 hasher.

    A pre-hashing peer (the compiled edge, the GEB client's fast
    framing) computes slot hashes in its own process; its keys land in
    the right store rows only when both sides run the SAME
    implementation. The frame doors' hello advertises this bit
    (HELLO_XXH64, serve/edge_bridge.py)."""
    _load_native()
    return _native_batch is not None


def slot_hash_is_xxh64() -> bool:
    """Whether the store's slot hash is XXH64, the hash the compiled edge
    pre-hashes with (native/edge/edge.cc): the edge bridge offers the
    edge pre-hashed frames only then (EdgeBridge._fast_ok)."""
    return using_native_hash()


def slot_hash(key: str) -> int:
    """64-bit slot hash of one key (same implementation as the batch path)."""
    return int(slot_hash_batch([key])[0])


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: derives an independent hash from one hash."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))
