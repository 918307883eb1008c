"""The port's two-tier engine and the promoter's engine surfaces against
the JAX package.

- `TorchEngine(sketch=...)` against the JAX flat engine (`TpuEngine`
  with the same SketchConfig) on one stream through `decide_arrays`,
  under tier pressure, both counter derivations: identical responses,
  stats, store bytes and sketch counters after every batch; reset and
  the epoch rebase clear the sketch on both;
- `sketch_estimates`, `live_mask`, `snapshot_read`, `install_windows`
  (token-replica and full-lane forms, duplicates last-wins, chunking
  past the ladder's top rung) and `promote_from_sketch` on engines that
  hold the same state;
- the device-sorted kernels: `decide` (arbitrary row order, invalid rows
  interspersed) and `upsert_globals` / `upsert_windows` against
  `decide` / `upsert_globals_jit` / `upsert_windows_jit`, plus the
  device sort key and its decode.

Inputs come from numpy seeds; tolerance is zero (integer math).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import store as jstore
from gubernator_tpu.core.engine import TpuEngine
from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JConfig
from gubernator_tpu_torch.core import kernels as tk
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import TorchEngine, to_device
from gubernator_tpu_torch.core.sketches import SketchConfig

T0 = 1_700_000_000_000
LADDER = (64, 128)
CPU = torch.device("cpu")
GEOMETRIES = {"v2": (2, 1 << 9, 4), "r13": (4, 1 << 8, 8)}


def _engines(derivation: str, rows=2, slots=16, buckets=LADDER):
    geo = GEOMETRIES[derivation]
    t = TorchEngine(
        tstore.StoreConfig(rows=rows, slots=slots), buckets=buckets,
        device="cpu", sketch=SketchConfig(*geo),
    )
    j = TpuEngine(JConfig(rows=rows, slots=slots), buckets=buckets, sketch=JSketchConfig(*geo))
    return t, j


def _stream(seed: int, steps: int, pool_n: int = 400, max_n: int = LADDER[-1]):
    """(now, fields): a pool far larger than the store, mixed algorithms,
    clock steps across window boundaries, one jump past the epoch
    envelope (a rebase) half way."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, pool_n, dtype=np.uint64)
    pool[:20] >>= np.uint64(32)
    now = T0
    for step in range(steps):
        now += int(rng.choice([0, 1, 7, 400, 999, 5000, 61_000]))
        if step == steps // 2:
            now += (1 << 30) + 12_345
        n = int(rng.integers(1, max_n + 1))
        idx = np.minimum(rng.zipf(1.3, n) - 1, pool.shape[0] - 1)
        yield now, pool, (
            pool[idx],
            rng.choice([0, 1, 1, 2, 5, 40], n).astype(np.int64),
            rng.choice([1, 3, 10, 100], n).astype(np.int64),
            rng.choice([1000, 60_000, 3_600_000], n).astype(np.int64),
            rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )


def _assert_same(t, j, msg, t_out=None, j_out=None):
    if t_out is not None:
        for a, b, name in zip(t_out, j_out, ("status", "limit", "remaining", "reset")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {msg}")
    np.testing.assert_array_equal(
        t.store.data.numpy(), np.asarray(j.store.data), err_msg=f"store {msg}"
    )
    np.testing.assert_array_equal(
        t.sketch.data.numpy(), np.asarray(j.sketch.data), err_msg=f"sketch {msg}"
    )
    assert t.stats.snapshot() == j.stats.snapshot(), msg
    assert t.clock.epoch == j.clock.epoch, msg


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_two_tier_engine_matches_jax_engine(derivation):
    t, j = _engines(derivation)
    rebases = 0
    for step, (now, _pool, fields) in enumerate(_stream(1, 30)):
        rebases += j.clock.epoch is not None and now - j.clock.epoch > jstore.REBASE_AT
        # the runtime A/B flag: steps 8-11 decide exact-only, sketch kept
        t.sketch_on = j.sketch_on = not 8 <= step < 12
        t_out = t.decide_arrays(*fields, now)
        j_out = j.decide_arrays(*fields, now)
        _assert_same(t, j, f"{derivation} step={step}", t_out, j_out)
        if step == 20:
            t.reset()
            j.reset()
            assert int(t.sketch.data.count_nonzero()) == 0
            assert int(t.store.data.count_nonzero()) == 0
            _assert_same(t, j, f"{derivation} after reset")
    snap = t.stats.snapshot()
    assert rebases == 1
    assert snap["dropped"] > 0 and snap["evictions"] > 0


def test_rebase_and_reset_clear_the_sketch():
    """Mirror of tests/test_sketch_tier.py:399 on the port, plus the
    rebase: both leave an all-zero sketch while the store keeps (rebase)
    or loses (reset) its entries, exactly as the JAX engine does."""
    t, j = _engines("v2", rows=1, slots=16, buckets=(64,))
    n = 48
    kh = (np.arange(1, n + 1, dtype=np.uint64) << np.uint64(32)) | np.uint64(7)
    ones = np.ones(n, np.int64)
    dur = np.full(n, 10_000, np.int64)
    for e in (t, j):
        e.decide_arrays(kh, ones, ones * 100, dur, np.zeros(n, np.int32), np.zeros(n, bool), T0)
    assert int(t.sketch_estimates(kh, dur, T0 + 1).sum()) > 0
    for e in (t, j):
        e._engine_now(T0 + (1 << 30) + 5)  # forces a store rebase
    assert int(t.sketch.data.count_nonzero()) == 0
    assert int(t.store.data.count_nonzero()) > 0
    _assert_same(t, j, "after rebase")
    for e in (t, j):
        e.decide_arrays(kh, ones, ones * 100, dur, np.zeros(n, np.int32), np.zeros(n, bool),
                        T0 + (1 << 30) + 6)
    t.reset()
    j.reset()
    assert int(t.sketch.data.count_nonzero()) == 0
    _assert_same(t, j, "after reset")


def _loaded_pair(derivation="v2", seed=3, steps=12, slots=16, buckets=LADDER):
    """A JAX engine driven through a stream, and a port engine carrying
    its state (store, sketch, epoch) via load_state."""
    t, j = _engines(derivation, slots=slots, buckets=buckets)
    last = None
    # the first half of the stream: before its epoch jump
    for now, pool, fields in _stream(seed, 2 * steps, max_n=max(buckets)):
        if now - T0 > (1 << 29):
            break
        j.decide_arrays(*fields, now)
        last = now
    t.load_state(
        np.asarray(j.store.data), j.clock.epoch, np.asarray(j.sketch.data)
    )
    t.stats.__init__()
    j.stats.__init__()
    return t, j, pool, last


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_host_reads_match_jax(derivation):
    t, j, pool, now = _loaded_pair(derivation)
    _assert_same(t, j, "loaded")
    rng = np.random.default_rng(11)
    kh = np.concatenate([pool[:150], rng.integers(0, 2**64, 20, dtype=np.uint64)])
    dur = rng.choice([1000, 60_000, 3_600_000], kh.shape[0]).astype(np.int64)
    for at in (now, now + 1, now + 2000, now + 70_000):
        np.testing.assert_array_equal(
            t.sketch_estimates(kh, dur, at), np.asarray(j.sketch_estimates(kh, dur, at))
        )
        np.testing.assert_array_equal(t.live_mask(kh, at), j.live_mask(kh, at))
        assert t.snapshot_read(kh, at) == j.snapshot_read(kh, at)
    assert t.live_mask(kh, now).any() and (t.sketch_estimates(kh, dur, now) > 0).any()
    # nothing above wrote anything
    _assert_same(t, j, "after reads")


def test_load_state_checks_shapes():
    t, j, _pool, _now = _loaded_pair()
    with pytest.raises(ValueError):
        t.load_state(np.asarray(j.store.data), j.clock.epoch,
                     np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError):
        t.load_state(np.asarray(j.store.data), j.clock.epoch,
                     np.asarray(j.sketch.data).astype(np.int64))
    exact = TorchEngine(tstore.StoreConfig(rows=2, slots=16), buckets=LADDER, device="cpu")
    with pytest.raises(ValueError):
        exact.load_state(np.asarray(j.store.data), j.clock.epoch, np.asarray(j.sketch.data))


def test_install_windows_both_forms_match_jax():
    """Token-replica and full-lane installs, with duplicate keys (the
    last in batch order wins) and more keys than the ladder's top rung
    (chunked in order), land the same bytes as the JAX engine's."""
    t, j, pool, now = _loaded_pair(buckets=(64,))
    rng = np.random.default_rng(21)
    n = 150  # > top rung 64: three chunks
    kh = rng.choice(np.concatenate([pool[:100], rng.integers(0, 2**64, 60, dtype=np.uint64)]), n)
    kh[100:110] = kh[5]  # duplicates across chunks
    limit = rng.integers(-5, 2**33, n)
    remaining = rng.integers(-5, 2**33, n)
    reset = now + rng.integers(-5000, 100_000, n)
    over = rng.random(n) < 0.3
    for e in (t, j):
        e.install_windows(kh, limit, remaining, reset, over, now)
    _assert_same(t, j, "replica install")
    assert t.live_mask(kh, now).any()
    flags = rng.integers(0, 16, n)
    duration = rng.integers(-10, 2**31, n)
    ts = rng.integers(-(2**31), 2**31, n)
    for e in (t, j):
        e.install_windows(kh, limit, remaining, reset, over, now + 1,
                          duration=duration, ts=ts, flags=flags)
    _assert_same(t, j, "full-lane install")
    # the last duplicate's lanes are the ones that landed
    assert t.snapshot_read(kh[5:6], now + 1) == j.snapshot_read(kh[5:6], now + 1)


def test_engine_counts_the_writebacks_no_decide_batch_counts():
    """Each window-install chunk and each gossip-charge chunk is one
    writeback launch outside EngineStats.batches: the engine counts them
    (install_chunks, gossip_chunks) so that a GPU run can require
    launches == batches + install_chunks + gossip_chunks; warmup zeroes
    them with the stats."""
    t = TorchEngine(tstore.StoreConfig(rows=2, slots=16), buckets=(64,), device="cpu")
    kh = np.arange(1, 151, dtype=np.uint64) << np.uint64(32)  # 150 keys: 3 chunks
    ones = np.ones(150, np.int64)
    t.install_windows(kh, ones * 5, ones * 5, ones * (T0 + 60_000), np.zeros(150, bool), T0)
    assert (t.install_chunks, t.gossip_chunks, t.stats.batches) == (3, 0, 0)
    t.apply_global_hits(kh[:65], ones[:65], ones[:65] * 5, ones[:65] * 60_000, T0)
    assert (t.install_chunks, t.gossip_chunks, t.stats.batches) == (3, 2, 0)
    # a decide counts as one EngineStats batch, not a chunk
    t.decide_arrays(kh[:3], ones[:3], ones[:3] * 5, ones[:3] * 60_000,
                    np.zeros(3, np.int32), np.zeros(3, bool), T0)
    assert (t.install_chunks, t.gossip_chunks, t.stats.batches) == (3, 2, 1)
    t.warmup(T0)
    assert (t.install_chunks, t.gossip_chunks, t.stats.batches) == (0, 0, 0)


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_promote_from_sketch_matches_jax(derivation):
    t, j, pool, now = _loaded_pair(derivation, seed=4)
    rng = np.random.default_rng(2)
    kh = np.concatenate([pool[:90], pool[:5]])  # duplicates too
    limits = rng.choice([1, 3, 10, 100], kh.shape[0])
    durs = rng.choice([1000, 60_000, 3_600_000], kh.shape[0])
    at = now + 3
    t_ret = t.promote_from_sketch(kh, limits, durs, at)
    j_ret = j.promote_from_sketch(kh, limits, durs, at)
    for a, b in zip(t_ret, j_ret):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t_ret[0].any() and (~t_ret[0]).any()  # installs and live skips
    _assert_same(t, j, "after promote")
    # the promoted keys then decide identically
    ones = np.ones(kh.shape[0], np.int64)
    fields = (kh, ones, limits, durs, np.zeros(kh.shape[0], np.int32), np.zeros(kh.shape[0], bool))
    _assert_same(t, j, "decide after promote",
                 t.decide_arrays(*fields, at + 1), j.decide_arrays(*fields, at + 1))


# -- device-sorted kernels -------------------------------------------------------


@jax.jit
def _jax_decide(data, req, now):
    st, resp, stats = jk.decide(jstore.Store(data=data), req, now)
    return st.data, jk.pack_outputs(resp, stats)


def _random_padded(rng, pool, n):
    idx = np.minimum(rng.zipf(1.3, n) - 1, pool.shape[0] - 1)
    return tk.BatchRequest(
        key_hash=pool[idx],
        hits=rng.choice([0, 1, 1, 2, 5], n).astype(np.int32),
        limit=rng.choice([0, 1, 3, 10, 100], n).astype(np.int32),
        duration=rng.choice([1, 1000, 60_000], n).astype(np.int32),
        algo=rng.integers(0, 4, n).astype(np.int32),
        gnp=rng.random(n) < 0.05,
        valid=rng.random(n) < 0.8,  # invalid rows interspersed
    )


def test_decide_device_sort_matches_jax():
    rng = np.random.default_rng(6)
    pool = rng.integers(0, 2**64, 300, dtype=np.uint64)
    pool[:10] |= np.uint64(1 << 63)
    j_data = jnp.zeros((16, 128), jnp.int32)
    t_store = tstore.new_store(tstore.StoreConfig(rows=16, slots=16), CPU)
    now = 1
    for step in range(16):
        now += int(rng.choice([0, 1, 50, 2000]))
        req = _random_padded(rng, pool, 128)
        if step == 3:
            req = req._replace(valid=np.zeros(128, bool))  # all invalid
        j_data, j_packed = _jax_decide(j_data, req, jnp.int32(now))
        _s, resp, stats = tk.decide(t_store, to_device(req, CPU), now)
        np.testing.assert_array_equal(
            tk.pack_outputs(resp, stats).numpy(), np.asarray(j_packed), err_msg=f"step {step}"
        )
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_data), err_msg=f"store step {step}"
        )


def test_upsert_globals_and_windows_match_jax():
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 2**64, 120, dtype=np.uint64)
    pool[:10] >>= np.uint64(32)
    j_data = jnp.zeros((16, 32), jnp.int32)
    t_store = tstore.new_store(tstore.StoreConfig(rows=4, slots=16), CPU)
    n = 128
    for step in range(10):
        kh = pool[rng.integers(0, pool.shape[0], n)]  # duplicates
        cols = dict(
            limit=rng.integers(-5, 2000, n).astype(np.int32),
            remaining=rng.integers(-5, 2000, n).astype(np.int32),
            reset_time=rng.integers(-1000, 1 << 30, n).astype(np.int32),
        )
        valid = rng.random(n) < 0.85
        kh_t = tstore.key_hash_tensor(kh)
        t_cols = {k: torch.from_numpy(v) for k, v in cols.items()}
        if step % 2:
            flags = rng.integers(0, 16, n).astype(np.int32)
            dur = rng.integers(0, 2**31 - 1, n).astype(np.int32)
            ts = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
            j_data = jk.upsert_windows_jit(
                jstore.Store(data=j_data), kh, cols["limit"], cols["remaining"],
                cols["reset_time"], dur, ts, flags, valid,
            ).data
            tk.upsert_windows(
                t_store, kh_t, t_cols["limit"], t_cols["remaining"],
                t_cols["reset_time"], torch.from_numpy(dur), torch.from_numpy(ts),
                torch.from_numpy(flags), torch.from_numpy(valid),
            )
        else:
            over = rng.random(n) < 0.3
            j_data = jk.upsert_globals_jit(
                jstore.Store(data=j_data), kh, cols["limit"], cols["remaining"],
                cols["reset_time"], over, valid,
            ).data
            tk.upsert_globals(
                t_store, kh_t, t_cols["limit"], t_cols["remaining"],
                t_cols["reset_time"], torch.from_numpy(over), torch.from_numpy(valid),
            )
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_data), err_msg=f"step {step}"
        )


def test_device_sort_key_matches_jax():
    """int64 bit patterns of the uint64 key, the all-ones sentinel of an
    invalid row sorting LAST under unsigned_order, and the unsigned clamp
    of its decode."""
    rng = np.random.default_rng(10)
    kh = rng.integers(0, 2**64, 500, dtype=np.uint64)
    kh[:40] >>= np.uint64(32)
    kh[40:80] |= np.uint64(1 << 63)
    valid = rng.random(500) < 0.7
    for buckets in (16, 1 << 20):
        j_key = np.asarray(jstore.group_sort_key(jnp.asarray(kh), jnp.asarray(valid), buckets))
        t_key = tstore.group_sort_key(tstore.key_hash_tensor(kh), torch.from_numpy(valid), buckets)
        np.testing.assert_array_equal(t_key.numpy().view(np.uint64), j_key)
        order = torch.argsort(tstore.unsigned_order(t_key), stable=True).numpy()
        np.testing.assert_array_equal(order, np.argsort(j_key, kind="stable"))
        assert not valid[order[-1]]
        t_b, t_fp = tstore.decode_sort_key(t_key[order], buckets)
        j_b, j_fp = jstore.decode_sort_key(jnp.asarray(j_key[order]), buckets)
        np.testing.assert_array_equal(t_b.numpy(), np.asarray(j_b))
        np.testing.assert_array_equal(t_fp.numpy(), np.asarray(j_fp))
