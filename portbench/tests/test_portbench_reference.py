"""The plain reference against hand-worked answers: a token bucket, a leaky
bucket and a key the sketch serves; and the sequential prefill."""

from __future__ import annotations

import numpy as np

from portbench.reference.limiter import (
    FLAG_ALGO_LEAKY,
    LANES,
    OVER,
    UNDER,
    Geometry,
    as_i32,
    bucket_index,
    decide_batch,
    fingerprint_u32,
    needed_counters,
    sketch_indices,
)
from portbench.reference.prefill import prefill_state

GEO = Geometry(buckets=64, ways=4)
GEO2 = Geometry(buckets=64, ways=4, sketch_rows=2, sketch_width=1024)
KEY = np.uint64(0x1234_5678_9ABC_DEF0)


def empty_rows(kh, geo):
    return {int(b): np.zeros(geo.ways * LANES, np.int32) for b in np.unique(bucket_index(kh, geo.buckets))}


def decide(kh, hits, limit, duration, algo, now, rows, counters=None, geo=GEO):
    n = len(kh)
    return decide_batch(np.asarray(kh, np.uint64), np.full(n, hits), np.full(n, limit),
                        np.full(n, duration), np.full(n, algo), now, rows, counters, geo)


def test_token_bucket_three_hits_limit_two():
    kh = np.array([KEY] * 3, np.uint64)
    ans, rows, _, st = decide(kh, 1, 2, 1000, 0, now=5000, rows=empty_rows(kh, GEO))
    # create leaves 1, the next hit 0, the third is refused; reset = now + duration
    assert ans.tolist() == [[UNDER, 2, 1, 6000], [UNDER, 2, 0, 6000], [OVER, 2, 0, 6000]]
    entry = rows[int(bucket_index(kh[:1], 64)[0])].reshape(4, LANES)[0]
    assert entry.tolist() == [int(as_i32(fingerprint_u32(kh[:1])[0])), 6000, 0, 5000, 2, 1000, 1,
                              int(as_i32(int(KEY) & 0xFFFFFFFF))]  # sticky over after z
    assert st == dict(hits=0, misses=1, dropped=0, evictions=0)
    # the next batch finds the live entry: still refused, same reset
    ans2, _, _, st2 = decide(kh[:1], 1, 2, 1000, 0, now=5500, rows=rows)
    assert ans2.tolist() == [[OVER, 2, 0, 6000]] and st2["hits"] == 1
    # past the window the key is created afresh
    ans3, _, _, _ = decide(kh[:1], 1, 2, 1000, 0, now=6001, rows=rows)
    assert ans3.tolist() == [[UNDER, 2, 1, 7001]]


def test_leaky_bucket_leaks_one_a_rate():
    kh = np.array([KEY] * 2, np.uint64)
    rows = empty_rows(kh, GEO)
    # limit 4 over 1000 ms: one token leaks back every 250 ms
    ans, rows, _, _ = decide(kh, 1, 4, 1000, 1, now=10_000, rows=rows)
    assert ans.tolist() == [[UNDER, 4, 3, 0], [UNDER, 4, 2, 0]]
    e = rows[int(bucket_index(kh[:1], 64)[0])].reshape(4, LANES)[0]
    assert e[6] == FLAG_ALGO_LEAKY and e[2] == 2 and e[3] == 10_000 and e[1] == 11_000
    # 600 ms later two tokens have leaked back: 2 + 2 = 4, one hit leaves 3
    ans, rows, _, _ = decide(kh[:1], 1, 4, 1000, 1, now=10_600, rows=rows)
    assert ans.tolist() == [[UNDER, 4, 3, 0]]
    # drain it: 3 more admitted, the fifth hit of the batch is refused, reset now + rate
    ans, _, _, _ = decide(np.array([KEY] * 5, np.uint64), 1, 4, 1000, 1, now=10_600, rows=rows)
    assert ans[:, 2].tolist() == [2, 1, 0, 0, 0]
    assert ans[3].tolist() == [OVER, 4, 0, 10_850]


def full_bucket_for(kh, geo, expire):
    """The key's bucket with every way held by another live key."""
    b = int(bucket_index(kh[:1], geo.buckets)[0])
    row = np.zeros((geo.ways, LANES), np.int32)
    for w in range(geo.ways):
        row[w] = [w + 1, expire, 10, 0, 10, 60_000, 0, w]
    return {b: row.reshape(-1)}


def test_sketch_serves_a_create_in_a_full_bucket():
    kh = np.array([KEY] * 3, np.uint64)
    now, dur = 120_500, 60_000
    rows = full_bucket_for(kh, GEO2, expire=200_000)
    idx = needed_counters(kh, np.full(3, dur), now, rows, GEO2)
    counters = {(r, int(i)): 0 for r in range(2) for i in idx[r]}
    own = sketch_indices(kh[:1], np.array([now // dur]), 2, 1024)[:, 0]
    counters[(0, int(own[0]))] = 7  # other keys' hits on one of its counters
    counters[(1, int(own[1]))] = 5
    ans, rows_post, cnt, st = decide(kh, 1, 7, dur, 0, now, rows, counters, GEO2)
    # the estimate is min(7, 5) = 5 hits: 2 left, then 1, 0, and the window's end
    end = (now // dur + 1) * dur
    assert ans.tolist() == [[UNDER, 7, 1, end], [UNDER, 7, 0, end], [OVER, 7, 0, end]]
    assert st["dropped"] == 1 and st["evictions"] == 0
    assert all((rows_post[b] == rows[b]).all() for b in rows)  # the store is untouched
    # conservative update: both counters rise to estimate + charged = 5 + 2
    assert cnt[(0, int(own[0]))] == 7 and cnt[(1, int(own[1]))] == 7


def test_exact_tier_without_sketch_evicts_the_earliest_expiry():
    kh = np.array([KEY], np.uint64)
    rows = full_bucket_for(kh, GEO, expire=200_000)
    b = next(iter(rows))
    rows[b].reshape(4, LANES)[2, 1] = 150_000  # way 2 expires first
    ans, post, _, st = decide(kh, 1, 5, 1000, 0, 120_000, rows)
    assert ans.tolist() == [[UNDER, 5, 4, 121_000]]
    assert st["evictions"] == 1
    assert post[b].reshape(4, LANES)[2, 0] == as_i32(fingerprint_u32(kh)[0])


def test_prefill_fills_ways_in_batch_then_fingerprint_order():
    geo = Geometry(buckets=4, ways=2, sketch_rows=2, sketch_width=256)
    kh = np.arange(1, 41, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    nows = [100, 200, 300, 400]
    rows, sketch, coll = prefill_state(lambda lo, hi: kh[lo:hi], 40, 10, nows, 1000, 60_000, geo, np.arange(4))
    bk = bucket_index(kh, 4)
    fp = fingerprint_u32(kh)
    assert not coll
    over = []
    for b in range(4):
        mine = sorted((i for i in range(40) if bk[i] == b), key=lambda i: (i // 10, fp[i]))
        got = rows[b].reshape(2, LANES)
        for w, i in enumerate(mine[:2]):
            t = nows[i // 10]
            assert got[w, 0] == as_i32(fp[i]) and got[w, 1] == t + 60_000 and got[w, 2] == 999
        over += mine[2:]
    # every key past the ways was charged to the sketch at its window
    idx = sketch_indices(kh[over], np.array([nows[i // 10] // 60_000 for i in over]), 2, 256)
    assert min(min(sketch[0, idx[0, j]], sketch[1, idx[1, j]]) for j in range(len(over))) >= 1
