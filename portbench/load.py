"""The one general load generator: turns a traffic mix (a data file) and a
configuration into request groups for the array door, and the open
loop's schedule. Groups are numbered; group k is the same for a seed
whichever caller sends it.

The groups are made ahead on a thread of their own, a chunk of
`chunk_groups` groups at a time (stream rows, their hashes and
algorithms: numpy, which leaves the GIL while it works), a few chunks
ahead of the callers, so that the callers only take slices. A caller that
finds its chunk not yet made waits, and the wait is counted
(`wait_s`): it says the generator, not the port, set the pace."""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from portbench.keyhash import hash_ids


class Load:
    """Groups of `traffic["group_rows"]` rows over the traffic's key stream,
    with the configuration's limits. `algo_by_id_parity` gives the
    algorithm of even and of odd key ids (0 token, 1 leaky). The stream's
    `ids(c, n)` is its c-th run of n rows; group k is rows
    [j * group_rows, (j + 1) * group_rows) of chunk c, where
    k = c * chunk_groups + j. Call `close()` when done."""

    def __init__(self, traffic: dict, config: dict, stream_mod, seed: int, start_id: int = 0):
        a = config["assumed"]
        self.rows = int(traffic["group_rows"])
        self.stream = stream_mod.Stream(traffic.get("stream_params", {}), int(config["key_space"]),
                                        int(seed), int(start_id))
        self.algo_of = np.asarray(traffic.get("algo_by_id_parity", [0, 0]), np.int32)
        self.chunk_groups = int(traffic.get("chunk_groups", 64))
        self.ahead = int(traffic.get("chunks_ahead", 4))
        n = self.rows
        self.const = dict(
            hits=np.full(n, int(traffic.get("hits", 1)), np.int64),
            limit=np.full(n, int(a["limit"]), np.int64),
            duration=np.full(n, int(a["duration_ms"]), np.int64),
        )
        self.wait_s = 0.0
        self._ready: dict = {}
        self._want = 0
        self._next = 0
        self._stop = False
        self._error = None
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._produce, name="portbench-load", daemon=True)
        self._thread.start()

    def chunk(self, c: int):
        """(key_hash uint64, algo int32) of chunk c."""
        ids = np.asarray(self.stream.ids(c, self.chunk_groups * self.rows), np.int64)
        return hash_ids(ids), self.algo_of[ids & 1]

    def _produce(self):
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(lambda: self._stop or self._next <= self._want + self.ahead)
                    if self._stop:
                        return
                    c = self._next
                made = self.chunk(c)
                with self._cv:
                    self._ready[c] = made
                    self._next = c + 1
                    self._cv.notify_all()
        except Exception as e:  # handed to the caller that waits
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def group(self, k: int) -> dict:
        """The k-th request group: key_hash (uint64) and the int arrays the
        array door takes; a fresh dict each call (the harness tells
        groups apart by identity). The harness takes groups in increasing
        k; an older group's chunk is made again where it was dropped."""
        c, j = divmod(int(k), self.chunk_groups)
        with self._cv:
            if c > self._want:
                self._want = c
                self._cv.notify_all()
                for old in [x for x in self._ready if x < c]:
                    del self._ready[old]
            if c not in self._ready and c < self._next:  # an older chunk, dropped: made again here
                self._ready[c] = self.chunk(c)
            if c not in self._ready:
                t0 = time.monotonic()
                self._cv.wait_for(lambda: c in self._ready or self._error is not None)
                self.wait_s += time.monotonic() - t0
                if self._error is not None:
                    raise RuntimeError("the load generator failed") from self._error
            kh, algo = self._ready[c]
        sl = slice(j * self.rows, (j + 1) * self.rows)
        return dict(key_hash=kh[sl], algo=algo[sl], **self.const)

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()


def open_schedule(rate: float, seconds: float, gap_seed: int, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of an open loop of
    Poisson arrivals at `rate` requests/s: round(rate * seconds)
    exponential gaps drawn once from `gap_seed`, scaled to fill the window
    exactly, then put in an order drawn from the run's seed. Every seed
    gets the same gaps, so seeds change the order, not the work."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(gap_seed).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    gaps = gaps[np.random.default_rng(seed % (1 << 64)).permutation(n)]
    return np.cumsum(gaps) - gaps


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest-rank rule over all
    values; infinity (a failed request) sorts last."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.nan
    rank = max(1, int(math.ceil(q / 100.0 * v.size)))
    return float(v[rank - 1])
