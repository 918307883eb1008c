"""Key ids to the uint64 slot hashes the array door takes: a frozen copy
of the repo's recipe (gubernator_tpu_torch/cli/keystreams.py `hash_ids`),
so that the yardstick cannot move with the program."""

from __future__ import annotations

import numpy as np

MIX_MUL = 0x9E3779B97F4A7C15
MIX_XOR = 0xDEADBEEFCAFEF00D


def hash_ids(ids: np.ndarray) -> np.ndarray:
    """uint64 key hashes of integer key ids."""
    return (np.asarray(ids).astype(np.uint64) * np.uint64(MIX_MUL)) ^ np.uint64(MIX_XOR)
