"""Inputs shared by the port's CPU and card tests (imports no jax, so the
card tests can use it on a host without JAX)."""

import numpy as np

#: the edges of the deltas kernel's tiling, as deltas_edge names them
DELTAS_EDGES = ("short", "one_row", "ragged", "one_run", "crossing")


def deltas_edge(case: str, krows: int, W: int = 128):
    """(bkt, drow) at an edge of the deltas kernel's tiling: fewer rows
    than a chunk, one row, a ragged count of chunks, one run over all of
    G (the decide's padded tail), and runs that cross every chunk edge."""
    rng = np.random.default_rng(krows)
    G = {"short": krows - 1, "one_row": 1, "ragged": 13 * krows + krows // 2,
         "one_run": 1000, "crossing": 20 * krows}[case]
    if case == "one_run":
        bkt = np.full(G, 7, np.int32)
    elif case == "crossing":
        bkt = ((np.arange(G) + krows // 2) // krows).astype(np.int32)
    else:
        bkt = np.sort(rng.integers(0, max(G // 2, 1), G)).astype(np.int32)
    drow = rng.integers(-(2**31), 2**31 - 1, (G, W), dtype=np.int64).astype(np.int32)
    return bkt, drow


#: the edges of the writeback kernel's tiling, as writeback_edge names them
WRITEBACK_EDGES = ("crossing", "long_runs", "padded_tail", "one_row", "ragged",
                   "sentinel", "one_run")


def writeback_edge(case: str, ktile: int, W: int = 128):
    """(data, bkt, drow, keep) where the writeback's tiles of `ktile` rows
    (a block a tile) have edges: runs that cross every tile boundary
    (`crossing`), runs three tiles long (`long_runs`), real rows then the
    decide's padded group tail, one run of 700 zero rows (`padded_tail`),
    G = 1, G not a multiple of the tile (`ragged`), the sentinel -1 ahead
    of the stream and buckets past the store behind it (`sentinel`), and
    one run over all of G (`one_run`). `keep` marks the rows whose bucket
    lies in the store (the kernel skips the others). Values span all of
    int32, so the adds wrap."""
    rng = np.random.default_rng(ktile * 1000 + W)
    buckets = 64
    if case == "crossing":
        bkt = (np.arange(20 * ktile) + ktile // 2 + 1) // ktile
    elif case == "long_runs":
        bkt = (np.arange(20 * ktile) + ktile // 2) // (3 * ktile)
    elif case == "padded_tail":
        real = np.sort(rng.choice(buckets, 37, replace=False))
        bkt = np.r_[real, np.full(700, real[-1])]
    elif case == "one_row":
        bkt = np.array([buckets - 1])
    elif case == "ragged":
        bkt = np.sort(rng.integers(0, buckets, 13 * ktile + ktile // 2 + 1))
    elif case == "sentinel":
        bkt = np.r_[np.full(ktile + 3, -1), np.sort(rng.integers(0, buckets, 5 * ktile)),
                    np.full(ktile - 1, buckets), [buckets + 7]]
    else:
        bkt = np.full(1000, 5)
    bkt = bkt.astype(np.int32)
    data = rng.integers(-(2**31), 2**31 - 1, (buckets, W), dtype=np.int64).astype(np.int32)
    drow = rng.integers(-(2**31), 2**31 - 1, (bkt.shape[0], W), dtype=np.int64).astype(np.int32)
    drow[rng.random(bkt.shape[0]) < 0.3] = 0
    if case == "padded_tail":
        drow[38:] = 0  # the padding rows carry zero deltas
    keep = (bkt >= 0) & (bkt < buckets)
    return data, bkt, drow, keep


#: the leader patterns of the segmented-scan tests, as scan_case names them
SCAN_PATTERNS = ("all_leaders", "one_segment", "random_runs", "zipf_runs")


def scan_case(pattern: str, n: int, k: int, seed: int = 0):
    """(is_leader bool[n], values int32[n, k]) for the segmented scans:
    every row a leader (the churn cells' groups), one segment over all
    of n, runs of random length, or zipf-distributed run lengths (hot
    keys' groups). Values are non-negative; about a third of the rows
    carry values near 2^31-1, so any segment of a few rows saturates."""
    rng = np.random.default_rng([seed, n, k, SCAN_PATTERNS.index(pattern)])
    if pattern == "all_leaders":
        lead = np.ones(n, bool)
    elif pattern == "one_segment":
        lead = np.zeros(n, bool)
        lead[:1] = True
    elif pattern == "random_runs":
        lead = rng.random(n) < 0.3
    else:
        starts = np.cumsum(np.minimum(rng.zipf(1.3, n), n))
        lead = np.zeros(n, bool)
        lead[:1] = True
        lead[starts[starts < n]] = True
    values = rng.integers(0, 50, (n, k), dtype=np.int64)
    big = rng.random((n, k)) < 0.3
    values[big] = rng.integers(2**30, 2**31 - 1, int(big.sum()), dtype=np.int64)
    return lead, values.astype(np.int32)
