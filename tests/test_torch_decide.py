"""Differential fuzz: the port's exact-tier decide_presorted against the
JAX package's, batch for batch.

Random streams over a small key pool go through both decides from the
same numpy inputs (made from a seed): all four algorithms mixed per
request, so same-batch duplicates disagree and stored entries mismatch
later requests; peeks (hits 0, leaky peeks included); oversized hits
(sticky-over token creations); zero and negative limits (the leaky
zero-limit guard); GLOBAL non-owner reads; durations at the sliding and
generic caps; irregular clock advances with epoch rebases applied to
both stores mid-stream; and a pool larger than the store, so buckets
exhaust their ways (dropped creates) and evict. After every batch the
store bytes and the packed responses + stats must be IDENTICAL
(tolerance zero: integer math), with the host group structure and
without it (groups=None derives it on the device). The shape follows
tests/test_fuzz_differential.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import store as jstore
from gubernator_tpu_torch.core import kernels as tk
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.sketches import SketchConfig, new_sketch
from gubernator_tpu_torch.core.engine import (
    _np_presort_grouped,
    build_groups,
    pad_request_sorted,
    to_device,
)

B = 256
CPU = torch.device("cpu")


@jax.jit
def _jax_decide(data, req, now, groups):
    store, resp, stats = jk.decide_presorted(jstore.Store(data=data), req, now, groups)
    return store.data, jk.pack_outputs(resp, stats)


@jax.jit
def _jax_decide_nogroups(data, req, now):
    store, resp, stats = jk.decide_presorted(jstore.Store(data=data), req, now)
    return store.data, jk.pack_outputs(resp, stats)


def _key_pool(rng, n: int) -> np.ndarray:
    pool = rng.integers(0, 2**64, n, dtype=np.uint64)
    pool[: n // 8] >>= np.uint64(32)  # high 32 bits zero: fingerprint 0 -> 1
    pool[n // 8 : n // 4] |= np.uint64(1 << 63)  # >= 2^63
    return pool


def _batch(rng, pool: np.ndarray):
    n = int(rng.integers(1, B + 1))
    # zipf-ish picks: a hot head makes duplicate runs inside a batch
    idx = np.minimum(rng.zipf(1.3, n) - 1, pool.shape[0] - 1)
    idx = np.where(rng.random(n) < 0.5, idx, rng.integers(0, pool.shape[0], n))
    return dict(
        key_hash=pool[idx],
        hits=rng.choice([0, 1, 1, 1, 2, 5, 40, -3, 2**40], n),
        limit=rng.choice([0, 1, 3, 8, 30, 1000, -5, 2**33], n),
        duration=rng.choice(
            [1, 100, 1000, 60_000, (1 << 29) + 5, (1 << 30) + 9, -50], n
        ),
        algo=rng.integers(0, 4, n).astype(np.int32),
        gnp=rng.random(n) < 0.1,
    )


def _pad(fields, buckets: int):
    """The presorted padded batch at ONE fixed shape (B rows, G = B
    group slots) so the JAX side compiles once."""
    req, _order = pad_request_sorted(
        (B,), buckets, fields["key_hash"], fields["hits"], fields["limit"],
        fields["duration"], fields["algo"], fields["gnp"],
    )
    n = fields["key_hash"].shape[0]
    _o, gid, lpos, G_real = _np_presort_grouped(fields["key_hash"], buckets)
    groups = build_groups(req.key_hash, gid, lpos, G_real, n, B, B)
    return req, groups


@pytest.mark.parametrize(
    "seed, buckets, rows, use_groups",
    [
        (1, 16, 16, True),  # 256 entries, ~600-key pool: drops + evictions
        (2, 16, 16, False),
        (3, 64, 4, True),  # narrow rows (W = 32)
        (4, 1024, 16, False),  # roomy store: long-lived state
    ],
)
def test_decide_presorted_matches_jax(seed, buckets, rows, use_groups):
    rng = np.random.default_rng(seed)
    pool = _key_pool(rng, 600)
    j_data = jnp.zeros((buckets, rows * tstore.LANES), jnp.int32)
    t_store = tstore.new_store(tstore.StoreConfig(rows=rows, slots=buckets), CPU)
    now = 1
    totals = np.zeros(4, np.int64)
    rebases = 0
    for step in range(40):
        now += int(rng.choice([0, 1, 3, 50, 400, 5000, 70_000, 1 << 28]))
        if now > jstore.REBASE_AT:
            # the engine's epoch rebase, applied to both stores
            delta = now - 1
            j_data = jk.rebase_jit(jstore.Store(data=j_data), jnp.int32(delta)).data
            tstore.rebase(t_store, delta)
            now, rebases = 1, rebases + 1
        req, groups = _pad(_batch(rng, pool), buckets)
        if use_groups:
            j_data, j_packed = _jax_decide(j_data, req, jnp.int32(now), groups)
            _s, resp, stats = tk.decide_presorted(
                t_store, to_device(req, CPU), now, to_device(groups, CPU)
            )
        else:
            j_data, j_packed = _jax_decide_nogroups(j_data, req, jnp.int32(now))
            _s, resp, stats = tk.decide_presorted(t_store, to_device(req, CPU), now)
        t_packed = tk.pack_outputs(resp, stats).numpy()
        j_packed = np.asarray(j_packed)
        assert t_packed.dtype == j_packed.dtype == np.int32
        np.testing.assert_array_equal(
            t_packed, j_packed, err_msg=f"packed seed={seed} step={step}"
        )
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_data),
            err_msg=f"store seed={seed} step={step}",
        )
        totals += j_packed[4 * B :]
    # the stream reached what it is meant to cover
    assert rebases >= 1
    assert totals[0] > 0 and totals[1] > 0  # live hits and creations
    if buckets == 16:
        assert totals[2] > 0 and totals[3] > 0  # dropped creates, evictions


def test_decide_unported_tiers_raise():
    """Quota chains are not ported and raise; the sketch tier is ported
    (tests/test_torch_sketch.py) and runs."""
    st = tstore.new_store(tstore.StoreConfig(rows=1, slots=16), CPU)
    req, groups = _pad(_batch(np.random.default_rng(0), np.arange(1, 9, dtype=np.uint64)), 16)
    sk = new_sketch(SketchConfig(rows=2, width=64), CPU)
    _st, got_sk, _resp, _stats = tk._decide_presorted(
        st, to_device(req, CPU), 1, None, sketch=sk
    )
    assert got_sk is sk
    with pytest.raises(NotImplementedError):
        tk._decide_presorted(st, to_device(req, CPU), 1, None, None,
                             chain_id=torch.zeros(B, dtype=torch.int32))


def test_floor_division_and_narrowing_match_jnp():
    """The decide's GCRA and sliding math divides negative operands
    (negative durations, windows before the epoch) and narrows int64 to
    int32: torch must floor and wrap exactly as jnp does."""
    rng = np.random.default_rng(12)
    for dt_np, dt_t in ((np.int32, torch.int32), (np.int64, torch.int64)):
        info = np.iinfo(dt_np)
        a = rng.integers(info.min // 2, info.max // 2, 4096, dtype=np.int64).astype(dt_np)
        b = rng.integers(-1000, 1000, 4096, dtype=np.int64).astype(dt_np)
        b[b == 0] = 7
        b[:100] = -np.abs(b[:100]) - 1  # negative divisors too
        a[:100] = -np.abs(a[:100])
        np.testing.assert_array_equal(
            (torch.from_numpy(a) // torch.from_numpy(b)).numpy(),
            np.asarray(jnp.asarray(a) // jnp.asarray(b)),
        )
        assert (torch.from_numpy(a) // torch.from_numpy(b)).dtype == dt_t
    wide = np.array([2**31, 2**32 + 5, -(2**31) - 1, -(2**40) - 3, 2**62, -1], np.int64)
    np.testing.assert_array_equal(
        torch.from_numpy(wide).to(torch.int32).numpy(),
        np.asarray(jnp.asarray(wide).astype(jnp.int32)),
    )
