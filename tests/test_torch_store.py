"""The port's store layer against gubernator_tpu.core.store.

Same numpy inputs, made from a seed, through the JAX function and its
PyTorch counterpart; every comparison is exact (tolerance zero: this is
integer bit math). The inputs include hashes >= 2^63 (negative as the
port's int64 bit patterns), hashes whose high 32 bits are zero
(fingerprint 0 -> 1) and sliding-window entries whose L_TS lane is a
count that rebase must leave alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import store as jstore
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import EpochClock, to_device
from gubernator_tpu_torch.core.kernels import BatchRequest


def _hashes(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    kh = rng.integers(0, 2**64, n, dtype=np.uint64)
    kh[:64] = rng.integers(0, 2**32, 64, dtype=np.uint64)  # fp == 0
    kh[64:128] |= np.uint64(1 << 63)  # >= 2^63
    kh[128] = np.uint64(0)
    kh[129] = np.uint64(2**64 - 1)
    kh[130] = np.uint64(1 << 63)
    kh[131] = np.uint64(1 << 32)
    return kh


def _t(kh: np.ndarray) -> torch.Tensor:
    return tstore.key_hash_tensor(kh)


@pytest.mark.parametrize("seed", [0, 1])
def test_mix64_matches_jax(seed):
    kh = _hashes(seed)
    want = np.asarray(jstore.mix64(jnp.asarray(kh)))
    got = tstore.mix64(_t(kh)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("buckets", [16, 1024, 1 << 21])
def test_bucket_index_matches_jax(buckets):
    kh = _hashes(buckets)
    want = np.asarray(jstore.bucket_index(jnp.asarray(kh), buckets))
    got = tstore.bucket_index(_t(kh), buckets).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_fingerprints_match_jax():
    kh = _hashes(7)
    want = np.asarray(jstore.fingerprints(jnp.asarray(kh)))
    got = tstore.fingerprints(_t(kh)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:64] == 1).all()  # high 32 bits zero -> tag 1
    assert (got != 0).all()


def test_group_sort_key_np_matches_jax():
    kh = _hashes(3)
    np.testing.assert_array_equal(
        tstore.group_sort_key_np(kh, 1024), jstore.group_sort_key_np(kh, 1024)
    )


def test_low32_wraps_like_bitcast():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, -1, -(2**63)])
    np.testing.assert_array_equal(
        tstore.low32(x).numpy(),
        np.array([0, 1, 2**31 - 1, -(2**31), -1, -1, 0], np.int32),
    )


def _random_store(seed: int, buckets: int, rows: int) -> np.ndarray:
    """Random entries across all four algorithms, times near the int32
    edges so the rebase clamp engages."""
    rng = np.random.default_rng(seed)
    ent = rng.integers(
        -(2**31), 2**31 - 1, (buckets, rows, tstore.LANES), dtype=np.int64
    )
    flags = rng.choice(
        [0, tstore.FLAG_ALGO_LEAKY, tstore.FLAG_ALGO_SLIDING,
         tstore.FLAG_ALGO_GCRA, tstore.FLAG_STICKY_OVER],
        (buckets, rows),
    )
    ent[..., tstore.L_FLAGS] = flags
    # sliding entries: L_TS is a COUNT (some huge, some small)
    sld = flags == tstore.FLAG_ALGO_SLIDING
    ent[..., tstore.L_TS] = np.where(
        sld & (rng.random((buckets, rows)) < 0.5), 7, ent[..., tstore.L_TS]
    )
    return ent.astype(np.int32).reshape(buckets, rows * tstore.LANES)


@pytest.mark.parametrize("delta", [1, 5000, (1 << 30) + 12345, -(1 << 29)])
def test_rebase_matches_jax(delta):
    data = _random_store(delta & 0xFFFF, 64, 16)
    want = np.asarray(
        jstore.rebase(jstore.Store(data=jnp.asarray(data)), jnp.int32(delta)).data
    )
    st = tstore.store_from_numpy(data, "cpu")
    got = tstore.rebase(st, delta)
    assert got.data.data_ptr() == st.data.data_ptr()  # in place
    np.testing.assert_array_equal(tstore.store_to_numpy(got), want)
    # the sliding count lane is untouched
    ent = want.reshape(64, 16, tstore.LANES)
    sld = ent[..., tstore.L_FLAGS] == tstore.FLAG_ALGO_SLIDING
    np.testing.assert_array_equal(
        ent[..., tstore.L_TS][sld],
        data.reshape(64, 16, tstore.LANES)[..., tstore.L_TS][sld],
    )


def test_rebase_chunks_cover_the_store(monkeypatch):
    monkeypatch.setattr(tstore, "_REBASE_CHUNK_ROWS", 5)
    data = _random_store(9, 32, 4)
    want = np.asarray(
        jstore.rebase(jstore.Store(data=jnp.asarray(data)), jnp.int32(777)).data
    )
    got = tstore.rebase(tstore.store_from_numpy(data, "cpu"), 777)
    np.testing.assert_array_equal(tstore.store_to_numpy(got), want)


@pytest.mark.parametrize(
    "kw", [dict(mib=1024), dict(mib=1), dict(target_keys=10_000_000),
           dict(mib=1, rows=4)]
)
def test_derive_store_config_matches_jax(kw):
    t = tstore.derive_store_config(**kw)
    j = jstore.derive_store_config(**kw)
    assert (t.rows, t.slots) == (j.rows, j.slots)
    if kw == dict(mib=1024):
        assert (t.rows, t.slots) == (16, 1 << 21)  # int32[2^21, 128] = 1 GiB


def test_new_store_layout_and_numpy_roundtrip():
    cfg = tstore.StoreConfig(rows=4, slots=32)
    st = tstore.new_store(cfg, "cpu")
    assert st.data.dtype == torch.int32
    assert tuple(st.data.shape) == tuple(jstore.new_store(
        jstore.StoreConfig(rows=4, slots=32)).data.shape)
    data = _random_store(2, 32, 4)
    np.testing.assert_array_equal(
        tstore.store_to_numpy(tstore.store_from_numpy(data, "cpu")), data
    )
    with pytest.raises(ValueError):
        tstore.store_from_numpy(data.astype(np.int64), "cpu")


def test_epoch_clock_matches_jax():
    from gubernator_tpu.core.engine import EpochClock as JClock

    a, b = EpochClock(), JClock()
    t = 1_700_000_000_000
    for step in (0, 1, 5000, 1 << 30, (1 << 30) + 7, -(1 << 29), 1 << 33, 3):
        t += step
        assert tuple(a.advance(t)) == tuple(b.advance(t))
        assert a.epoch == b.epoch


def test_to_device_keeps_hash_bits():
    kh = _hashes(5)[120:136]  # spans >= 2^63, 0 and 2^64-1
    req = BatchRequest(
        key_hash=kh, hits=np.ones(16, np.int32), limit=np.ones(16, np.int32),
        duration=np.ones(16, np.int32), algo=np.zeros(16, np.int32),
        gnp=np.zeros(16, bool), valid=np.ones(16, bool),
    )
    t = to_device(req, torch.device("cpu"))
    assert t.key_hash.dtype == torch.int64
    np.testing.assert_array_equal(t.key_hash.numpy().view(np.uint64), kh)
    assert t.gnp.dtype == torch.bool and t.hits.dtype == torch.int32
