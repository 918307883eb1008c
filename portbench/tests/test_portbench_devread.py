"""The recorder's device readings against their NumPy twins on the CPU: the
digests, their certainty for a single changed word, their additivity, and
the counters a row's eviction victim can read."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.devread import (
    CHUNK,
    Digester,
    digest_np,
    lane_salts,
    mix64_t,
    term_np,
    victim_counters,
)
from portbench.reference.limiter import (
    L_DURATION,
    L_EXPIRE,
    L_KEYLOW,
    L_TAG,
    LANES,
    Geometry,
    mix64,
    needed_counters,
)

SALTS = lane_salts(2**31 + 99, CHUNK)


def test_mix64_matches_the_reference():
    x = np.random.default_rng(1).integers(0, 2**63, 4096, dtype=np.int64).view(np.uint64) * np.uint64(3)
    got = mix64_t(torch.from_numpy(x.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, mix64(x))


@pytest.mark.parametrize("dtype,block", [(np.int32, 7), (np.int32, 64), (np.int64, 5)])
def test_device_digest_matches_numpy(dtype, block):
    rng = np.random.default_rng(2)
    info = np.iinfo(dtype)
    rows = rng.integers(info.min, info.max, (50, CHUNK), dtype=dtype, endpoint=True)
    d = Digester(SALTS, CHUNK, block, "cpu")
    out = torch.empty(50, dtype=torch.int64)
    d.into(out, torch.from_numpy(rows))
    assert np.array_equal(out.numpy().view(np.uint64), digest_np(rows, SALTS))
    d.subtract(out, torch.from_numpy(rows))
    assert not out.any()


def test_a_single_changed_word_always_moves_the_digest():
    rng = np.random.default_rng(3)
    rows = rng.integers(-2**31, 2**31, (2000, CHUNK), dtype=np.int64).astype(np.int32)
    lane = rng.integers(0, CHUNK, 2000)
    new = rows.copy()
    delta = rng.integers(1, 2**32, 2000, dtype=np.int64)
    new[np.arange(2000), lane] = (rows[np.arange(2000), lane].astype(np.int64) + delta).astype(np.int32)
    assert (digest_np(rows, SALTS) != digest_np(new, SALTS)).all()


def test_the_digest_moves_by_the_changed_words_terms():
    rng = np.random.default_rng(4)
    row = rng.integers(0, 1000, (1, CHUNK), dtype=np.int64)
    new = row.copy()
    lanes = np.array([3, 90, 127])
    new[0, lanes] += np.array([1, 7, 1 << 40])
    with np.errstate(over="ignore"):
        moved = digest_np(new, SALTS) - digest_np(row, SALTS)
        by_terms = (term_np(new[0, lanes], lanes, SALTS) - term_np(row[0, lanes], lanes, SALTS)).sum(
            dtype=np.uint64)
    assert moved[0] == by_terms


def test_victim_counters_cover_the_references():
    geo = Geometry(buckets=64, ways=4, sketch_rows=2, sketch_width=1 << 12)
    rng = np.random.default_rng(5)
    n = 40
    rows = np.zeros((n, geo.ways, LANES), np.int32)
    live = rng.random((n, geo.ways)) < 0.8
    rows[:, :, L_TAG] = np.where(live, rng.integers(1, 2**31, (n, geo.ways)), 0)
    rows[:, :, L_KEYLOW] = rng.integers(-2**31, 2**31, (n, geo.ways))
    rows[:, :, L_EXPIRE] = rng.integers(0, 5, (n, geo.ways)) * 1000  # ties: the first way wins
    rows[:, :, L_DURATION] = rng.integers(0, 70_000, (n, geo.ways))
    now = 123_456
    out = torch.empty(geo.sketch_rows * n, dtype=torch.int64)
    victim_counters(torch.from_numpy(rows.reshape(n, -1)), now, geo.ways, geo.sketch_rows,
                    geo.sketch_width, out)
    got = set(out.tolist())
    pre = {b: rows[b].reshape(-1) for b in range(n)}
    ref = needed_counters(np.zeros(0, np.uint64), np.zeros(0, np.int64), now, pre, geo)
    want = {r * geo.sketch_width + int(i) for r in range(geo.sketch_rows) for i in ref[r]}
    assert want and want <= got
