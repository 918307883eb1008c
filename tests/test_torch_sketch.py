"""The port's sketch cold tier against the JAX package's.

- geometry: `derive_sketch_config` (both derivations) and the port's
  MiB carve-out of one budget into exact tier + sketch, against
  `ServerConfig(store_mib=..., sketch=...)` of the serving tier;
- indexing: the port's device lookup (`_sketch_lookup`) and host twin
  (`sketch_indices_np`) against JAX's twins, at hashes >= 2^63,
  fingerprint 0 and window ids -1 (window 0's "previous"), 0 and large;
- the two-tier decide: a differential fuzz of `decide_presorted_sketch`
  under tier pressure (a pool larger than the store, all four
  algorithms, duplicates, clock steps across window boundaries, dead and
  sticky-over victims, both counter derivations, a sketch started near
  the int32 ceiling so the saturating write runs), identical store,
  sketch and packed outputs after every batch;
- the window-ring host twins (`sketch_sliding_budget`,
  `sketch_gcra_budget`) against JAX's, and as the oracle of a single
  sketch-served key driven through the port's engine;
- the zero-under-count property of the tier, run on the port.

Inputs come from numpy seeds; tolerance is zero (integer math).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import algorithms as jalgo
from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import sketches as jsk
from gubernator_tpu.core import store as jstore
from gubernator_tpu.serve.config import ServerConfig
from gubernator_tpu_torch.core import algorithms as talgo
from gubernator_tpu_torch.core import kernels as tk
from gubernator_tpu_torch.core import sketches as tsk
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import (
    TorchEngine,
    _np_presort_grouped,
    build_groups,
    pad_request_sorted,
    to_device,
)

B = 256
CPU = torch.device("cpu")
T0 = 1_700_000_000_000
I32_MAX = (1 << 31) - 1


# -- geometry -----------------------------------------------------------------


def _cfg_tuple(c):
    return None if c is None else (c.rows, c.width, c.counter_bytes)


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_derive_sketch_config_matches_jax(derivation):
    for mib in (1, 2, 3, 7, 8, 16, 100, 256):
        for rows in (0, 1, 2, 4, 8):
            t = tsk.derive_sketch_config(mib, rows=rows, derivation=derivation)
            j = jsk.derive_sketch_config(mib, rows=rows, derivation=derivation)
            assert _cfg_tuple(t) == _cfg_tuple(j), (mib, rows)
            assert tsk.sketch_footprint_bytes(t) == jsk.sketch_footprint_bytes(j)
            assert tsk.new_sketch(t, CPU).data.dtype == (
                torch.int32 if j.counter_bytes == 4 else torch.int64
            )
    for bad in (dict(mib=0), dict(mib=8, derivation="r12")):
        with pytest.raises(ValueError):
            jsk.derive_sketch_config(**bad)
        with pytest.raises(ValueError):
            tsk.derive_sketch_config(**bad)
    assert tsk.SKETCH_SALTS == jsk.SKETCH_SALTS
    assert tsk.WINDOW_MIX == jsk.WINDOW_MIX
    assert tsk.SKETCH_DERIVATIONS == jsk.SKETCH_DERIVATIONS


def test_two_tier_carve_out_matches_server_config():
    """GUBER_STORE_MIB covers both tiers: the port's carve-out derives the
    same exact tier and sketch as the serving tier's config."""
    for store_mib in (1, 3, 4, 16, 64, 1024, 4096):
        for sketch, sketch_mib in ((False, 0), (True, 0), (True, 1), (True, 8)):
            for derivation in ("v2", "r13"):
                conf = ServerConfig(
                    backend="tpu", store_mib=store_mib, sketch=sketch,
                    sketch_mib=sketch_mib, sketch_derivation=derivation,
                )
                try:
                    want = (conf.store_config(), conf.sketch_config())
                except ValueError:
                    with pytest.raises(ValueError):
                        tsk.derive_two_tier_config(
                            store_mib, sketch, sketch_mib, derivation=derivation
                        )
                    continue
                got = tsk.derive_two_tier_config(
                    store_mib, sketch, sketch_mib, derivation=derivation
                )
                assert (got[0].rows, got[0].slots) == (want[0].rows, want[0].slots)
                assert _cfg_tuple(got[1]) == _cfg_tuple(want[1]), (
                    store_mib, sketch, sketch_mib, derivation,
                )
    # the deployment chip_smoke.py runs: 805,306,368 bytes on the card
    store, skc = tsk.derive_two_tier_config(1024)
    assert (store.slots, store.rows) == (1 << 20, 16)
    assert (skc.rows, skc.width, skc.counter_bytes) == (2, 1 << 25, 4)
    assert store.slots * store.rows * 32 + tsk.sketch_footprint_bytes(skc) == 805_306_368


# -- indexing -----------------------------------------------------------------


def _trap_hashes(rng, n):
    kh = rng.integers(0, 2**64, n, dtype=np.uint64)
    kh[: n // 4] |= np.uint64(1 << 63)  # >= 2^63
    kh[n // 4 : n // 2] >>= np.uint64(32)  # fingerprint 0
    kh[-1] = np.uint64(2**64 - 1)
    kh[-2] = np.uint64(0)
    return kh


@pytest.mark.parametrize("counter_bytes", [4, 8])
def test_sketch_index_twins_match_jax(counter_bytes):
    rng = np.random.default_rng(counter_bytes)
    n = 64
    kh = _trap_hashes(rng, n)
    cfg_t = tsk.SketchConfig(rows=4, width=1 << 12, counter_bytes=counter_bytes)
    cfg_j = jsk.SketchConfig(rows=4, width=1 << 12, counter_bytes=counter_bytes)
    dt = np.int32 if counter_bytes == 4 else np.int64
    data = rng.integers(0, np.iinfo(dt).max, (4, 1 << 12), dtype=np.int64).astype(dt)
    sk_t = tsk.Sketch(data=torch.from_numpy(data))
    sk_j = jk.Sketch(data=jnp.asarray(data))
    kh_t = tstore.key_hash_tensor(kh)
    # int32 window ids as the decide has them: -1 is window 0's previous
    for w in (-1, 0, 1, 7, 2**31 - 1, -(2**31)):
        wid32 = np.full(n, w, np.int32)
        est_t, idx_t = tk._sketch_lookup(sk_t, kh_t, torch.from_numpy(wid32))
        est_j, idx_j = jk._sketch_lookup(sk_j, jnp.asarray(kh), jnp.asarray(wid32))
        np.testing.assert_array_equal(est_t.numpy(), np.asarray(est_j), err_msg=str(w))
        assert est_t.dtype == torch.int64
        for a, b in zip(idx_t, idx_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(w))
        host = jsk.sketch_indices_np(kh, wid32.astype(np.int64), cfg_j)
        np.testing.assert_array_equal(np.stack([i.numpy() for i in idx_t]), host)
    # int64 window ids on the host twins, past int32 range
    wid64 = rng.integers(-(2**40), 2**40, n)
    wid64[:3] = (-1, 0, 2**62)
    np.testing.assert_array_equal(
        tsk.sketch_indices_np(kh, wid64, cfg_t), jsk.sketch_indices_np(kh, wid64, cfg_j)
    )
    np.testing.assert_array_equal(
        tsk.window_id_np(12345, np.array([1, 7, 0, -5, 60_000])),
        jsk.window_id_np(12345, np.array([1, 7, 0, -5, 60_000])),
    )


def test_int64_traps_match_uint64():
    """The uint64 operations of the sketch branch, done on int64 bit
    patterns: the window-mix multiply wraps to the same low 64 bits, and
    a key rebuilt from (tag as uint32) << 32 | (keylow as uint32) has the
    bits jnp's bitcasts give."""
    rng = np.random.default_rng(5)
    wid = rng.integers(-(2**31), 2**31, 512).astype(np.int64)
    want = wid.view(np.uint64) * np.uint64(tsk.WINDOW_MIX)
    got = torch.from_numpy(wid) * tsk.WINDOW_MIX_I64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    tag = rng.integers(-(2**31), 2**31, 512).astype(np.int32)
    low = rng.integers(-(2**31), 2**31, 512).astype(np.int32)
    tag[:2], low[:2] = (-1, I32_MAX), (-1, -(2**31))
    got = ((torch.from_numpy(tag).to(torch.int64) & 0xFFFFFFFF) << 32) | (
        torch.from_numpy(low).to(torch.int64) & 0xFFFFFFFF
    )
    want = (tag.view(np.uint32).astype(np.uint64) << np.uint64(32)) | low.view(
        np.uint32
    ).astype(np.uint64)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


# -- the two-tier decide, differential ------------------------------------------


@jax.jit
def _jax_decide_sketch(data, sk, req, now, groups):
    st, skn, resp, stats = jk.decide_presorted_sketch(
        jstore.Store(data=data), jk.Sketch(data=sk), req, now, groups
    )
    return st.data, skn.data, jk.pack_outputs(resp, stats)


@jax.jit
def _jax_decide_sketch_nogroups(data, sk, req, now):
    st, skn, resp, stats = jk.decide_presorted_sketch(
        jstore.Store(data=data), jk.Sketch(data=sk), req, now
    )
    return st.data, skn.data, jk.pack_outputs(resp, stats)


def _key_pool(rng, n: int) -> np.ndarray:
    pool = rng.integers(0, 2**64, n, dtype=np.uint64)
    pool[: n // 8] >>= np.uint64(32)  # fingerprint 0 -> 1
    pool[n // 8 : n // 4] |= np.uint64(1 << 63)  # >= 2^63
    return pool


def _batch(rng, pool: np.ndarray):
    n = int(rng.integers(1, B + 1))
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
    group slots) so the JAX side compiles once per sketch geometry."""
    req, _order = pad_request_sorted(
        (B,), buckets, fields["key_hash"], fields["hits"], fields["limit"],
        fields["duration"], fields["algo"], fields["gnp"],
    )
    n = fields["key_hash"].shape[0]
    _o, gid, lpos, G_real = _np_presort_grouped(fields["key_hash"], buckets)
    return req, build_groups(req.key_hash, gid, lpos, G_real, n, B, B)


@pytest.mark.parametrize(
    "seed, derivation, rows, use_groups, hot",
    [
        (1, "v2", 16, True, False),  # 256 entries, 600-key pool
        (2, "r13", 16, True, False),
        (3, "v2", 4, False, False),  # narrow rows, device-side groups
        (4, "v2", 16, True, True),  # counters start near the int32 ceiling
        (5, "r13", 4, True, True),
    ],
)
def test_decide_presorted_sketch_matches_jax(seed, derivation, rows, use_groups, hot):
    rng = np.random.default_rng(seed)
    buckets = 16
    pool = _key_pool(rng, 600)
    sk_rows, cbytes = tsk.SKETCH_DERIVATIONS[derivation]
    width = 1 << 8  # small: collisions inflate estimates
    dt = np.int32 if cbytes == 4 else np.int64
    if hot:
        top = np.iinfo(dt).max
        sk0 = rng.integers(top - 2000, top, (sk_rows, width), dtype=np.int64)
        sk0[:, : width // 2] = rng.integers(0, 50, (sk_rows, width // 2))
        sk0 = sk0.astype(dt)
    else:
        sk0 = np.zeros((sk_rows, width), dt)
    j_data = jnp.zeros((buckets, rows * tstore.LANES), jnp.int32)
    j_sk = jnp.asarray(sk0)
    t_store = tstore.new_store(tstore.StoreConfig(rows=rows, slots=buckets), CPU)
    t_sk = tsk.Sketch(data=torch.from_numpy(sk0.copy()))
    now = 1
    totals = np.zeros(4, np.int64)
    rebases = 0
    for step in range(40):
        now += int(rng.choice([0, 1, 3, 50, 400, 999, 5000, 70_000, 1 << 28]))
        if step == 30:
            now += jstore.REBASE_AT
        if now > jstore.REBASE_AT:
            # the engine's epoch rebase: shift the store, clear the sketch
            delta = now - 1
            j_data = jk.rebase_jit(jstore.Store(data=j_data), jnp.int32(delta)).data
            j_sk = jnp.zeros_like(j_sk)
            tstore.rebase(t_store, delta)
            t_sk.data.zero_()
            now, rebases = 1, rebases + 1
        req, groups = _pad(_batch(rng, pool), buckets)
        if use_groups:
            j_data, j_sk, j_packed = _jax_decide_sketch(
                j_data, j_sk, req, jnp.int32(now), groups
            )
            t_groups = to_device(groups, CPU)
        else:
            j_data, j_sk, j_packed = _jax_decide_sketch_nogroups(
                j_data, j_sk, req, jnp.int32(now)
            )
            t_groups = None
        _s, _k, resp, stats = tk.decide_presorted_sketch(
            t_store, t_sk, to_device(req, CPU), now, t_groups
        )
        j_packed = np.asarray(j_packed)
        msg = f"seed={seed} step={step}"
        np.testing.assert_array_equal(
            tk.pack_outputs(resp, stats).numpy(), j_packed, err_msg=f"packed {msg}"
        )
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_data), err_msg=f"store {msg}"
        )
        np.testing.assert_array_equal(
            t_sk.data.numpy(), np.asarray(j_sk), err_msg=f"sketch {msg}"
        )
        assert t_sk.data.dtype == (torch.int32 if cbytes == 4 else torch.int64)
        totals += j_packed[4 * B :]
    # the stream reached what it is meant to cover
    assert rebases >= 1
    assert totals[0] > 0 and totals[1] > 0  # live hits and creations
    assert totals[2] > 0  # sketch-served (dropped) groups
    assert totals[3] > 0  # dead victims recycled (the fold's candidates)
    if hot and cbytes == 4:
        # folds onto near-ceiling v2 counters saturated at the int32 max
        assert int(t_sk.data.max()) == I32_MAX


def test_gcra_floor_division_of_negative_budgets():
    """now + tau - TAT_q goes negative for a refused sketch-served GCRA
    key: the port floors like jnp (trunc would round toward zero)."""
    a = torch.tensor([-7, -1, 0, 5, -(2**40) - 3], dtype=torch.int64)
    b = torch.tensor([2, 3, 4, 2, 7], dtype=torch.int64)
    got = torch.div(a, b, rounding_mode="floor").numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(a.numpy()) // jnp.asarray(b.numpy())))
    assert got[0] == -4 and got[1] == -1


# -- window-ring host twins ------------------------------------------------------


def test_window_ring_host_twins_match_jax():
    rng = np.random.default_rng(8)
    assert talgo.SKETCH_SERVABLE_ALGOS == jalgo.SKETCH_SERVABLE_ALGOS
    for _ in range(3000):
        est_c, est_p = (int(x) for x in rng.integers(0, 3000, 2))
        now = int(rng.integers(0, 1 << 30))
        limit = int(rng.choice([-5, 0, 1, 3, 100, 2000, I32_MAX]))
        dur = int(rng.choice([-3, 0, 1, 7, 1000, 60_000, (1 << 29) - 1]))
        assert talgo.gcra_params(limit, dur) == jalgo.gcra_params(limit, dur)
        assert talgo.sketch_sliding_budget(est_c, est_p, now, limit, dur) == (
            jalgo.sketch_sliding_budget(est_c, est_p, now, limit, dur)
        )
        assert talgo.sketch_gcra_budget(est_c, est_p, now, limit, dur) == (
            jalgo.sketch_gcra_budget(est_c, est_p, now, limit, dur)
        )


def _filler_hashes(slots: int) -> np.ndarray:
    """One key hash per store bucket (cli/bench_serving._filler_hashes
    with the port's hashing): kept live and in every batch, these pin
    every way, so each measured key is decided by the sketch."""
    out = {}
    rng = np.random.default_rng(123)
    while len(out) < slots:
        cand = rng.integers(1, 2**63, 1024).astype(np.uint64)
        bkt = (tstore.group_sort_key_np(cand, slots) >> np.uint64(32)).astype(np.int64)
        for h, b in zip(cand.tolist(), bkt.tolist()):
            out.setdefault(int(b), h)
    return np.array([out[b] for b in range(slots)], np.uint64)


def _pin_buckets(eng) -> np.ndarray:
    fillers = _filler_hashes(eng.config.slots)
    ones = np.ones(fillers.shape[0], np.int64)
    eng.decide_arrays(
        fillers, ones, ones * 1000, ones * 1_000_000_000,
        np.zeros(fillers.shape[0], np.int32), np.zeros(fillers.shape[0], bool), T0,
    )
    return fillers


@pytest.mark.parametrize("cbytes", [8, 4], ids=["r13-int64", "v2-int32"])
@pytest.mark.parametrize("algo", [2, 3], ids=["sliding", "gcra"])
def test_window_ring_twin_oracle_on_port(algo, cbytes):
    """A sketch-served sliding/GCRA key through the port's engine matches
    its host twin bit for bit across window rotations, multi-window jumps
    and sub-window steps (the shape of tests/test_sketch_tier.py's
    test_window_ring_twin_oracle), and the ring never under-counts."""
    skc = tsk.SketchConfig(rows=4 if cbytes == 8 else 2, width=1 << 12, counter_bytes=cbytes)
    eng = TorchEngine(
        tstore.StoreConfig(rows=1, slots=16), buckets=(64,), device="cpu", sketch=skc
    )
    fillers = _pin_buckets(eng)
    nf = fillers.shape[0]
    key = np.array([(11 << 32) | 11], np.uint64)
    DUR, LIM = 10_000, 4
    epoch = T0 - 1  # EpochClock pins one ms before first contact
    true_charges: dict = {}

    def ring_est(wid):
        idx = tsk.sketch_indices_np(key, np.array([wid], np.int64), skc)
        data = eng.sketch.data.numpy()
        return int(min(data[r, idx[r][0]] for r in range(skc.rows)))

    t = T0
    for dt in (0, 1, 1, 1, 1, 1, 3000, 1, 1, 6000, 1, 1, 15_000,
               1, 1, 1, 1, 25_001, 1, 2, 3, 9_999, 1):
        t += dt
        e_now = t - epoch
        wid = e_now // DUR
        est_cur, est_prev = ring_est(wid), ring_est(wid - 1)
        if algo == 2:
            budget, wend = talgo.sketch_sliding_budget(est_cur, est_prev, e_now, LIM, DUR)
            exp_reset = epoch + wend
        else:
            budget, tatq = talgo.sketch_gcra_budget(est_cur, est_prev, e_now, LIM, DUR)
            T_, tau = talgo.gcra_params(LIM, DUR)
            tatq_c = min(tatq, I32_MAX)
            exp_reset = epoch + min(tatq_c + T_ - (0 if budget >= 1 else tau), I32_MAX)
        charged = budget >= 1
        kh = np.concatenate([fillers, key])
        hits = np.concatenate([np.zeros(nf, np.int64), [1]])
        lim = np.full(nf + 1, LIM, np.int64)
        lim[:nf] = 1000
        dur = np.full(nf + 1, DUR, np.int64)
        dur[:nf] = 1_000_000_000
        al = np.full(nf + 1, algo, np.int32)
        al[:nf] = 0
        s, l, r, ts = eng.decide_arrays(kh, hits, lim, dur, al, np.zeros(nf + 1, bool), t)
        assert s[-1] == (0 if charged else 1), f"status @t={t}"
        assert r[-1] == (budget - 1 if charged else 0), f"remaining @t={t}"
        assert ts[-1] == exp_reset, f"reset @t={t}"
        assert l[-1] == LIM
        if charged:
            true_charges[wid] = true_charges.get(wid, 0) + 1
            assert ring_est(wid) >= true_charges[wid]
    assert len(true_charges) >= 3, "drive never crossed rotations"
    assert eng.stats.snapshot()["evictions"] == 0


# -- the error property, on the port ----------------------------------------------


@pytest.mark.parametrize("algo", [0, 2, 3], ids=["token", "sliding", "gcra"])
def test_tail_error_bound_and_no_undercount_on_port(algo):
    """The acceptance property of tests/test_sketch_tier.py:748, on the
    port: a pinned zipf stream where every measured key is sketch-served
    (filler rig, huge limits so every hit charges) leaves ZERO
    under-counts, and the max overestimate stays within e*N/width."""
    skc = tsk.derive_sketch_config(mib=8)  # v2: 2 x 2^20 int32, as measured there
    eng = TorchEngine(
        tstore.StoreConfig(rows=1, slots=64), buckets=(4096,), device="cpu", sketch=skc
    )
    fill = _pin_buckets(eng)
    nf = fill.shape[0]
    Bm = 4096
    nm = Bm - nf
    hits = np.concatenate([np.zeros(nf, np.int64), np.ones(nm, np.int64)])
    limit = np.full(Bm, 1 << 30, np.int64)
    dur = np.full(Bm, 600_000, np.int64)
    al = np.full(Bm, algo, np.int32)
    al[:nf] = 0
    rng = np.random.default_rng(7)
    true = np.zeros(10_000, np.int64)
    batches = 16 if algo == 0 else 8
    for b in range(batches):
        ids = rng.zipf(1.2, nm) % 10_000
        kh = np.concatenate(
            [fill, (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
             ^ np.uint64(0xDEADBEEFCAFEF00D)]
        )
        eng.decide_arrays(kh, hits, limit, dur, al, np.zeros(Bm, bool), T0 + b)
        np.add.at(true, ids, 1)
    touched = np.flatnonzero(true)
    est = eng.sketch_estimates(
        (touched.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        ^ np.uint64(0xDEADBEEFCAFEF00D),
        np.full(touched.shape[0], 600_000), T0 + batches + 1,
    )
    diff = est - true[touched]
    assert int((diff < 0).sum()) == 0
    assert diff.max() <= math.e * int(true.sum()) / skc.width
    assert eng.stats.snapshot()["dropped"] >= touched.shape[0]
    assert touched.shape[0] > 500
