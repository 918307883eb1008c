"""Each key stream reproduces the recipe it was copied from: the churn
stream and the hash exactly, the zipf stream by its distribution."""

from __future__ import annotations

import importlib.util

import numpy as np
import pytest

from portbench.keyhash import hash_ids
from portbench.load import Load, open_schedule

from conftest import PORTBENCH, REPO


def stream(name):
    spec = importlib.util.spec_from_file_location("s_" + name.replace("-", "_"),
                                                  PORTBENCH / "streams" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 11, 2**33 + 5])
@pytest.mark.parametrize("key_space", [10_000_000, 100_000_000])
def test_zipf_draws_keystreams_distribution(seed, key_space):
    """The stream's draws follow the distribution of keystreams.zipf_ids
    (numpy's zipf(1.2) folded into the key space): the head ids' shares,
    the tail's share past the alias table and past 10^6, and the number
    of distinct ids agree within six standard errors."""
    from gubernator_tpu_torch.cli import keystreams

    n = 1 << 21
    got = stream("zipf").Stream({"a": keystreams.ZIPF_A}, key_space, seed).ids(0, n)
    want = keystreams.zipf_ids(key_space, n, np.random.default_rng(seed))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < key_space
    masks = [lambda x: x == 1, lambda x: x == 2, lambda x: x == 5,
             lambda x: (x > 100) & (x <= 1000), lambda x: x > 65536, lambda x: x > 10**6]
    for m in masks:
        p = m(want).mean()
        se = np.sqrt(p * (1 - p) / n) * np.sqrt(2)
        assert abs(m(got).mean() - p) < 6 * se + 1e-9, (m(got).mean(), p)
    d_got, d_want = np.unique(got).size, np.unique(want).size
    assert abs(d_got - d_want) < 0.01 * d_want


def test_zipf_chunks_are_fresh_draws_and_repeat_for_a_seed():
    """Chunk c of a seed is the same every time; different chunks are
    independent draws, so the tail brings new ids all through a run."""
    z = stream("zipf")
    a, b = z.Stream({}, 100_000_000, 9), z.Stream({}, 100_000_000, 9)
    assert np.array_equal(a.ids(3, 4096), b.ids(3, 4096))
    assert not np.array_equal(a.ids(3, 4096), a.ids(4, 4096))
    seen = set()
    new = []
    for c in range(8):
        ids = set(a.ids(c, 1 << 16).tolist())
        new.append(len(ids - seen))
        seen |= ids
    assert min(new[1:]) > 0.5 * new[0]  # every chunk brings mostly ids never seen


def test_zipf_matches_chip_smoke_recipe_constants():
    """The hash the groups carry is the one chip_smoke.zipf_hashes and
    keystreams use for the same ids."""
    import sys

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from gubernator_tpu_torch.cli import keystreams

    ids = keystreams.zipf_ids(100_000_000, 4096, np.random.default_rng(3))
    assert np.array_equal(hash_ids(ids), chip_smoke.zipf_hashes(4096, seed=3, key_space=100_000_000))


@pytest.mark.parametrize("phase", [0, 1, 7, 5000])
def test_key_churn_matches_keystreams(phase):
    from gubernator_tpu_torch.cli import keystreams

    c = stream("key-churn")
    size = 4096
    got = hash_ids(c.churn_ids(100_000_000, size, phase * size))
    assert np.array_equal(got, keystreams.churn_pool(100_000_000, size, phase))


def test_hash_ids_matches_keystreams():
    from gubernator_tpu_torch.cli import keystreams

    ids = np.arange(0, 1 << 20, 977, dtype=np.int64)
    assert np.array_equal(hash_ids(ids), keystreams.hash_ids(ids))


def test_load_groups_repeat_for_a_seed_and_algo_follows_parity():
    cfg = dict(assumed=dict(limit=1000, duration_ms=60_000), key_space=1000)
    tr = dict(group_rows=64, algo_by_id_parity=[0, 1], stream_params={}, chunk_groups=4)
    a = Load(tr, cfg, stream("zipf"), seed=5)
    b = Load(tr, cfg, stream("zipf"), seed=5)
    try:
        for k in (0, 1, 99, 3):
            ga, gb = a.group(k), b.group(k)
            assert all(np.array_equal(ga[f], gb[f]) for f in ga)
        ids = a.stream.ids(0, 4 * 64)[3 * 64:4 * 64]  # group 3: chunk 0's fourth group
        g3 = a.group(3)
        assert np.array_equal(g3["key_hash"], hash_ids(ids))
        assert np.array_equal(g3["algo"], ids % 2)
        assert a.wait_s >= 0.0
    finally:
        a.close()
        b.close()
    churn = Load(dict(tr, stream_params={}), cfg, stream("key-churn"), seed=0, start_id=100)
    try:
        assert np.array_equal(churn.group(2)["key_hash"], hash_ids((100 + 128 + np.arange(64)) % 1000))
        assert np.array_equal(churn.group(5)["key_hash"], hash_ids((100 + 320 + np.arange(64)) % 1000))
    finally:
        churn.close()


def test_open_schedule_same_gaps_for_every_seed():
    s1 = open_schedule(500.0, 2.0, 1000, seed=1)
    s2 = open_schedule(500.0, 2.0, 1000, seed=2)
    assert s1.shape == s2.shape == (1000,)
    assert s1[0] == 0.0 and s1[-1] < 2.0
    g1 = np.sort(np.diff(np.r_[s1, 2.0]))
    g2 = np.sort(np.diff(np.r_[s2, 2.0]))
    assert np.allclose(g1, g2) and not np.array_equal(s1, s2)
