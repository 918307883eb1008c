"""The port's sketch promoter against the JAX package's, on the CPU.

- `_topk_update` (plain torch, in place) against the reference's jitted
  update run eagerly: ties in weight and in key, hashes at and above
  2^63, zero weights, the empty-slot key 0, batches smaller and larger
  than the table, several steps feeding each table back;
- `DeviceTopK` observe, decay and `top_with_payload`, and `HotTracker`
  folding dispatched BatchRequests, against the reference's;
- one `SketchPromoter.flush_once` on both serving stacks after the same
  traffic: the same promotions, shed seeds, store and sketch bytes.

Inputs come from numpy seeds; tolerance is zero (integer math).
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.api.types as j_types
import gubernator_tpu.core.hashing as j_hashing
import gubernator_tpu.serve.promoter as jp
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.serve.promoter as tp
from gubernator_tpu.core.kernels import BatchRequest as JBatchRequest
from gubernator_tpu_torch.core.kernels import BatchRequest

T0 = 1_700_000_000_000


def _keys(rng, n, pool):
    """n keys from `pool` with repeats; pool holds values >= 2^63."""
    return pool[rng.integers(0, pool.shape[0], n)]


def _pool(rng, m):
    pool = rng.integers(1, 2**64, m, dtype=np.uint64)
    pool[: m // 3] |= np.uint64(1 << 63)  # top bit set: int64-negative
    pool[m // 3] = np.uint64(1 << 63)
    return pool


def _as_t(x_u64):
    return torch.from_numpy(np.ascontiguousarray(x_u64, np.uint64).view(np.int64)).clone()


@pytest.mark.parametrize("B, K", [(16, 64), (128, 32), (128, 128), (7, 7)])
def test_topk_update_matches_jax(B, K):
    rng = np.random.default_rng(B * 1000 + K)
    pool = _pool(rng, max(4, K // 2 + B // 3))
    kh_t = np.zeros(K, np.uint64)
    cnt_t = np.zeros(K, np.int64)
    filled = K // 3
    kh_t[:filled] = pool[:filled]  # some table keys the batches match
    cnt_t[:filled] = rng.integers(1, 4, filled)  # small counts: ties
    t_kh, t_cnt = _as_t(kh_t), torch.from_numpy(cnt_t.copy())
    j_kh, j_cnt = jnp.asarray(kh_t), jnp.asarray(cnt_t)
    for step in range(6):
        kb = _keys(rng, B, pool)
        wb = rng.choice([0, 0, 1, 1, 2, 3], B).astype(np.int64)  # zeros + ties
        kb[rng.random(B) < 0.1] = 0  # padding-shaped rows
        got = tp._topk_update(t_kh, t_cnt, _as_t(kb), torch.from_numpy(wb))
        assert got[0] is t_kh and got[1] is t_cnt  # updated in place
        j_kh, j_cnt = jp._topk_update(j_kh, j_cnt, jnp.asarray(kb), jnp.asarray(wb))
        np.testing.assert_array_equal(
            t_kh.numpy().view(np.uint64), np.asarray(j_kh), err_msg=f"keys step {step}"
        )
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt), err_msg=f"step {step}")
    assert (t_cnt.numpy() > 0).sum() > filled  # inserts happened


def test_device_topk_observe_decay_top_match_jax():
    rng = np.random.default_rng(5)
    pool = _pool(rng, 300)
    t = tp.DeviceTopK(64, device="cpu")
    j = jp.DeviceTopK(64)
    for step in range(12):
        n = int(rng.integers(1, tp.OBSERVE_TOP + 1))
        kh = np.unique(_keys(rng, n, pool))
        w = rng.integers(0, 9, kh.shape[0]).astype(np.int64)
        pay = {int(k): (int(rng.integers(1, 50)), 1000) for k in kh[: kh.shape[0] // 2]}
        t.observe_arrays(kh, w, dict(pay))
        j.observe_arrays(kh, w, dict(pay))
        if step % 4 == 3:
            t.decay()
            j.decay()
            assert t._counts == j._counts
        assert t.top_with_payload(20) == j.top_with_payload(20), step
    t.observe_weighted({int(pool[0]): 5, int(pool[1]): 2}, {int(pool[0]): (3, 60_000)})
    j.observe_weighted({int(pool[0]): 5, int(pool[1]): 2}, {int(pool[0]): (3, 60_000)})
    assert t.top_with_payload(64) == j.top_with_payload(64)
    assert t._payloads == j._payloads


def test_hot_tracker_folds_batches_like_jax(monkeypatch):
    """HotTracker.observe on dispatched BatchRequests (valid, promotable,
    hit-carrying rows only; the heaviest OBSERVE_TOP distinct keys)."""
    monkeypatch.setattr(jp, "OBSERVE_MIN_INTERVAL_S", 0.0)
    monkeypatch.setattr(tp, "OBSERVE_MIN_INTERVAL_S", 0.0)
    rng = np.random.default_rng(8)
    pool = _pool(rng, 400)
    t = tp.HotTracker(32, device="cpu")
    j = jp.HotTracker(32)
    for _ in range(5):
        B = 512
        cols = dict(
            key_hash=pool[np.minimum(rng.zipf(1.2, B) - 1, pool.shape[0] - 1)],
            hits=rng.choice([0, 1, 1, 2], B).astype(np.int32),
            limit=rng.choice([5, 10], B).astype(np.int32),
            duration=np.full(B, 60_000, np.int32),
            algo=rng.integers(0, 4, B).astype(np.int32),
            gnp=np.zeros(B, bool),
            valid=rng.random(B) < 0.9,
        )
        t.observe(BatchRequest(**cols))
        j.observe(JBatchRequest(**cols))
    assert t.ss.top_with_payload(32) == j.ss.top_with_payload(32)


def test_sketch_promoter_flush_once_matches_jax(monkeypatch):
    """One promoter tick on both serving stacks after the same sketch-
    tier traffic: the same candidates promoted, the same over-limit
    candidates seeded into the shed cache, the same store and sketch."""
    from test_torch_serving import FakeClock, _stacks

    c = FakeClock()
    monkeypatch.setattr(j_types, "millisecond_now", c)
    monkeypatch.setattr(t_types, "millisecond_now", c)
    monkeypatch.setattr(j_hashing, "_native_checked", True)
    monkeypatch.setattr(j_hashing, "_native_batch", None)
    monkeypatch.setattr(jp, "OBSERVE_MIN_INTERVAL_S", 0.0)
    monkeypatch.setattr(tp, "OBSERVE_MIN_INTERVAL_S", 0.0)

    async def run():
        t, j = await _stacks(c, True)
        try:
            rng = np.random.default_rng(12)
            pool = rng.integers(0, 2**64, 200, dtype=np.uint64)
            for step in range(10):
                c.t += 3
                n = 48
                f = dict(
                    key_hash=pool[np.minimum(rng.zipf(1.1, n) - 1, pool.shape[0] - 1)],
                    hits=rng.choice([1, 2, 3], n).astype(np.int64),
                    limit=np.full(n, 4, np.int64),
                    duration=np.full(n, 60_000, np.int64),
                    algo=np.zeros(n, np.int32),
                )
                a = await t.batcher.decide_arrays(dict(f))
                b = await j.batcher.decide_arrays(dict(f))
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))
            c.t += 1
            await t.promoter.flush_once()
            await j.promoter.flush_once()
            st = t.promoter.stats()
            assert st == j.promoter.stats()
            assert st["promotions"] > 0 and st["shed_seeds"] > 0, st
            assert dict(t.shed._entries) == dict(j.shed._entries)
            te, je = t.backend.engine, j.backend.engine
            np.testing.assert_array_equal(te.store.data.numpy(), np.asarray(je.store.data))
            np.testing.assert_array_equal(te.sketch.data.numpy(), np.asarray(je.sketch.data))
        finally:
            await t.stop()
            await j.stop()

    asyncio.run(run())
