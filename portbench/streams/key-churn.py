"""key-churn: sequential ids, every group fresh: group k holds ids
start + k*rows onwards, folded into the key space. A frozen copy of
gubernator_tpu_torch/cli/keystreams.py `churn_pool` (phase p of size n
is start = p*n).

`start` is the first id past what the configuration prefilled, moved on
by the seed (`seed_stride` ids a seed step, `seed_steps` steps). The
stream's own `key_space` (a parameter, else the configuration's) bounds
the ids: a flood of source addresses draws from 2^32 of them, so a run
never wraps back onto ids it or the prefill used."""

from __future__ import annotations

import numpy as np


def churn_ids(key_space: int, size: int, start: int) -> np.ndarray:
    ks = np.uint64(max(int(key_space), 1))
    return (np.arange(size, dtype=np.uint64) + np.uint64(int(start))) % ks


class Stream:
    def __init__(self, params: dict, key_space: int, seed: int, start: int = 0):
        self.key_space = int(params.get("key_space", key_space))
        steps = int(params.get("seed_steps", 1024))
        self.start = int(start) + (int(seed) % steps) * int(params.get("seed_stride", 4096))

    def ids(self, k: int, rows: int) -> np.ndarray:
        return churn_ids(self.key_space, rows, self.start + k * rows).astype(np.int64)
