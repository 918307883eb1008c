"""The plain reference of a sequential-id prefill: the state a fresh store
(and sketch) holds after `n_ids` fresh token keys, hits 1, were decided
in batches of `batch_rows` consecutive ids, batch b at engine time
`nows[b]`.

Every key is new, so each is a create: the ids of one bucket take its
empty ways in batch order, by fingerprint within a batch (the store's
sort order); once a bucket's ways are full, every later create of it is
served by the sketch, whose counters take max(counter, estimate + 1)
at the key's window, the estimate read before the batch.

Without a sketch a sampled bucket's rows follow from its own keys alone,
so the ids are hashed a block at a time and only those of sampled buckets
kept: memory and time follow the sample, not the store. With a sketch
every overflowing create moves counters that others read, so every batch
is replayed, each hashed as it comes (one NumPy pass a batch).
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

HASH_BLOCK = 1 << 22  # ids hashed at once where no sketch needs every batch


def _entries(fp, t, duration, limit, kh):
    """int32-valued [n, LANES] entries of fresh token keys created at `t`."""
    n = fp.shape[0]
    t = np.broadcast_to(np.asarray(t, np.int64), (n,))
    return np.stack([as_i32(fp), t + duration, np.full(n, limit - 1), t, np.full(n, limit),
                     np.full(n, duration), np.zeros(n, np.int64),
                     as_i32(kh.astype(np.int64) & 0xFFFFFFFF)], axis=1)


def _collisions(rows: np.ndarray, want: np.ndarray) -> list:
    """Sampled buckets where two written ways share a fingerprint."""
    tags = np.sort(rows[:, :, L_TAG], axis=1)
    dup = (tags[:, 1:] == tags[:, :-1]) & (tags[:, 1:] != 0)
    return want[dup.any(axis=1)].tolist()


def prefill_state(kh_of, n_ids: int, batch_rows: int, nows, limit: int, duration: int,
                  geo: Geometry, buckets_wanted: np.ndarray):
    """(rows int32[len(buckets_wanted), ways*8], sketch int64[rows, width]
    or None, collisions) after the prefill of ids 0 .. n_ids-1, whose
    uint64 key hashes `kh_of(lo, hi)` gives for ids lo .. hi-1 (in send
    order). `buckets_wanted` is sorted. `collisions` lists buckets where
    two keys share a fingerprint; their rows are not predicted (the
    caller leaves them out)."""
    nows = np.asarray(nows, np.int64)
    want = np.asarray(buckets_wanted, np.int64)
    rows = np.zeros((want.shape[0], geo.ways, LANES), np.int32)
    if not geo.two_tier:
        _sampled_rows(kh_of, n_ids, batch_rows, nows, limit, duration, geo, want, rows)
        return rows.reshape(want.shape[0], -1), None, _collisions(rows, want)
    fill = np.zeros(geo.buckets, np.int32)  # ways taken so far, a bucket
    pos = np.full(geo.buckets, -1, np.int32)  # a bucket's place in the sample
    pos[want] = np.arange(want.shape[0])
    sketch = np.zeros((geo.sketch_rows, geo.sketch_width), np.int64)
    r_ix = np.arange(geo.sketch_rows)[:, None]
    for b, s0 in enumerate(range(0, n_ids, batch_rows)):
        k = np.asarray(kh_of(s0, min(n_ids, s0 + batch_rows)), np.uint64)
        m = k.shape[0]
        bk = bucket_index(k, geo.buckets)
        fp = fingerprint_u32(k)
        order = np.argsort((bk.astype(np.uint64) << np.uint64(32)) | fp.astype(np.uint64), kind="stable")
        k, bk, fp = k[order], bk[order], fp[order]
        first = np.r_[True, bk[1:] != bk[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(m), 0))
        rank = fill[bk] + np.arange(m) - start
        cuts = np.flatnonzero(first)
        fill[bk[cuts]] += np.diff(np.r_[cuts, m]).astype(np.int32)
        t = int(nows[b])
        res = rank < geo.ways
        sel = res & (pos[bk] >= 0)
        rows[pos[bk[sel]], rank[sel]] = _entries(fp[sel], t, duration, limit, k[sel])
        if not res.all():
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
    return rows.reshape(want.shape[0], -1), sketch, _collisions(rows, want)


def _sampled_rows(kh_of, n_ids, batch_rows, nows, limit, duration, geo, want, rows) -> None:
    """Without a sketch: the ids of sampled buckets, found a block at a
    time, each taking its bucket's rank-th way in (batch, fingerprint)
    order while a way is left."""
    keep = []
    for s0 in range(0, n_ids, HASH_BLOCK):
        ids = np.arange(s0, min(n_ids, s0 + HASH_BLOCK), dtype=np.int64)
        k = np.asarray(kh_of(int(ids[0]), int(ids[-1]) + 1), np.uint64)
        bk = bucket_index(k, geo.buckets)
        pos = np.searchsorted(want, bk)
        sel = (pos < want.shape[0]) & (want[np.minimum(pos, want.shape[0] - 1)] == bk)
        keep.append((ids[sel], k[sel], pos[sel]))
    ids, k, pos = (np.concatenate(x) for x in zip(*keep)) if keep else (np.zeros(0, np.int64),) * 3
    k = k.astype(np.uint64)
    batch = ids // batch_rows
    fp = fingerprint_u32(k)
    order = np.lexsort((ids, fp, batch, pos))
    ids, k, pos, batch, fp = ids[order], k[order], pos[order], batch[order], fp[order]
    first = np.r_[True, pos[1:] != pos[:-1]] if pos.shape[0] else np.zeros(0, bool)
    rank = np.arange(pos.shape[0]) - np.maximum.accumulate(np.where(first, np.arange(pos.shape[0]), 0))
    sel = rank < geo.ways
    t = nows[batch[sel]]
    rows[pos[sel], rank[sel]] = _entries(fp[sel], t, duration, limit, k[sel])
