"""The plain reference of a sequential-id prefill: the state a fresh store
(and sketch) holds after `n_ids` fresh token keys, hits 1, were decided
in batches of `batch_rows` consecutive ids, batch b at engine time
`nows[b]`.

Every key is new, so each is a create: the ids of one bucket take its
empty ways in batch order, by fingerprint within a batch (the store's
sort order); once a bucket's ways are full, every later create of it is
served by the sketch, whose counters take max(counter, estimate + 1)
at the key's window, the estimate read before the batch. Vectorised
over ids; one NumPy pass a batch for the sketch.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.limiter import (
    I32_MAX,
    L_TAG,
    LANES,
    Geometry,
    as_i32,
    bucket_index,
    fingerprint_u32,
    sketch_indices,
)


def prefill_state(kh: np.ndarray, batch_rows: int, nows, limit: int, duration: int,
                  geo: Geometry, buckets_wanted: np.ndarray):
    """(rows int32[len(buckets_wanted), ways*8], sketch int64[rows, width]
    or None, collisions) after the prefill of keys `kh` (uint64, in send
    order). `collisions` lists buckets where two keys share a fingerprint;
    their rows are not predicted (the caller leaves them out)."""
    kh = np.asarray(kh, np.uint64)
    n = kh.shape[0]
    nows = np.asarray(nows, np.int64)
    want = np.asarray(buckets_wanted, np.int64)
    pos = np.full(geo.buckets, -1, np.int64)
    pos[want] = np.arange(want.shape[0])
    rows = np.zeros((want.shape[0], geo.ways, LANES), np.int32)
    fill = np.zeros(geo.buckets, np.int64)  # ways taken so far, a bucket
    sketch = np.zeros((geo.sketch_rows, geo.sketch_width), np.int64) if geo.two_tier else None
    r_ix = np.arange(geo.sketch_rows)[:, None]
    for b, s0 in enumerate(range(0, n, batch_rows)):
        k = kh[s0:s0 + batch_rows]
        m = k.shape[0]
        bk = bucket_index(k, geo.buckets)
        fp = fingerprint_u32(k)
        order = np.argsort((bk.astype(np.uint64) << np.uint64(32)) | fp.astype(np.uint64), kind="stable")
        k, bk, fp = k[order], bk[order], fp[order]
        first = np.r_[True, bk[1:] != bk[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(m), 0))
        rank = fill[bk] + np.arange(m) - start
        cuts = np.flatnonzero(first)
        fill[bk[cuts]] += np.diff(np.r_[cuts, m])
        t = int(nows[b])
        res = rank < geo.ways
        sel = res & (pos[bk] >= 0)
        rows[pos[bk[sel]], rank[sel]] = np.stack([
            as_i32(fp[sel]), np.full(sel.sum(), t + duration), np.full(sel.sum(), limit - 1),
            np.full(sel.sum(), t), np.full(sel.sum(), limit), np.full(sel.sum(), duration),
            np.zeros(sel.sum(), np.int64), as_i32(k[sel].astype(np.int64) & 0xFFFFFFFF)], axis=1)
        if sketch is not None and not res.all():
            over = k[~res]
            ix = sketch_indices(over, np.full(over.shape[0], t // max(duration, 1)),
                                geo.sketch_rows, geo.sketch_width)
            est = sketch[r_ix, ix].min(axis=0)
            upd = np.minimum(est + ((limit - np.minimum(est, limit)) >= 1), I32_MAX)
            for r in range(geo.sketch_rows):  # scatter-max: the largest update an index wins
                o = np.lexsort((upd, ix[r]))
                last = np.r_[ix[r][o][1:] != ix[r][o][:-1], True]
                i, v = ix[r][o][last], upd[o][last]
                sketch[r, i] = np.maximum(sketch[r, i], v)
    collisions = []
    for i, b in enumerate(want):
        tags = rows[i, :, L_TAG]
        tags = tags[tags != 0]
        if np.unique(tags).shape[0] != tags.shape[0]:
            collisions.append(int(b))
    return rows.reshape(want.shape[0], -1), sketch, collisions
