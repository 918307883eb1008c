"""Key hashing (the port's copy of gubernator_tpu.core.hashing).

1. Ring hash: crc32 of the key, the reference's consistent-hash point
   (reference hash.go:40-42).
2. Slot hash: a 64-bit hash of the key that picks the store bucket and
   the 32-bit fingerprint tag. It is local to one process, so any
   stable 64-bit hash serves; the port uses blake2b-8 and has no native
   XXH64 batch hasher.

`mix64` here is the numpy splitmix64 finalizer; core.store carries its
torch twin for key hashes held as int64 bit patterns.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Iterable

import numpy as np


def ring_hash(key: str) -> int:
    """crc32 point on the ring, matching reference hash.go:40-42."""
    return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF


def slot_hash(key: str) -> int:
    """64-bit slot hash of one key (blake2b-8, little-endian)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "little"
    )


def slot_hash_batch(keys: Iterable[str]) -> np.ndarray:
    """uint64[len(keys)] of slot hashes."""
    return np.array([slot_hash(k) for k in keys], dtype=np.uint64)


def slot_hash_is_xxh64() -> bool:
    """Whether the store's slot hash is XXH64, the hash the compiled edge
    pre-hashes with (native/edge/edge.cc). Never, while the port has no
    native hasher: the frame doors read this before they offer
    pre-hashed frames to a peer that can only hash XXH64."""
    return False


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: derives an independent hash from one hash."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))
