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
