"""The programs the card captures besides the decide, against the JAX package.

On the card each window install, GLOBAL step, state read and top-k fold
is a captured CUDA graph (core/graphs.py) that reads its inputs from one
static byte buffer: an `InstallLayout`, `RequestLayout`, `ReadLayout`
or `TopKLayout` filled through a pinned staging ring, `now` a 0-d int32
tensor there. A mesh's graph runs every shard of its device, each masked
by owner (parallel/sharded.py `install_program`, `sync_charge_program`
and `sync_install_program`, `rows_program`, `sketch_min_program`). On
the CPU the same layouts, ring and programs run eagerly, so these tests
hold them against the JAX package's jitted programs from the same
seeded numpy inputs, byte for byte (tolerance zero: integer math):

- on 2 and 4 CPU shards (tests/conftest.py's simulated devices), the
  mesh's `_sync`, `_upsert`, `_upsert_full`, `_rows_sharded` and the
  collective `_rows_coll`, `_sketch_min_sharded` and `_sketch_min_coll`
  (gubernator_tpu/parallel/sharded.py:783-880, :1046-1105, :2364-2390),
  with the shards run as one device (the GLOBAL step as one graph) and
  as two (its charge and install as two graphs, the parts summed between);
- on the flat engine, `upsert_globals_jit`, `upsert_windows_jit`
  (gubernator_tpu/core/kernels.py:1667-1685), `_rows_flat` and
  `_sketch_min_flat`;
- the promoter's jitted `_topk_update` (gubernator_tpu/serve/promoter.py).

They also hold the warmups' walk of those programs (which rungs each
captures) against the JAX warmups'. Capture and replay need the card:
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import store as jstore
from gubernator_tpu.core.engine import TpuEngine
from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.parallel import sharded as jsh
from gubernator_tpu.parallel.policy import shard_map_compat
from gubernator_tpu.serve import promoter as jp
from gubernator_tpu_torch.core import graphs
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import (
    DEFAULT_BUCKETS,
    TorchEngine,
    buckets_for_limit,
    choose_bucket,
    extend_ladder,
    pad_request_sorted,
    pad_to_bucket,
)
from gubernator_tpu_torch.core.sketches import Sketch, SketchConfig, sketch_indices_np
from gubernator_tpu_torch.parallel.sharded import (
    READ_RUNGS,
    MeshEngine,
    install_program,
    owner_of_np,
    rows_program,
    sketch_min_program,
    sync_charge_program,
    sync_install_program,
)
from gubernator_tpu_torch.serve import promoter as tp

CPU = torch.device("cpu")
T0 = 1_700_000_000_000
BUCKETS = (64, 128)
STORE = dict(rows=4, slots=16)  # small: drops and evictions
SKETCH = dict(rows=2, width=1 << 8)
WAYS = 4  # the warmup walk's stores: StoreConfig(rows=4, slots=64)


def _key_pool(rng, n: int) -> np.ndarray:
    pool = rng.integers(0, 2**64, n, dtype=np.uint64)
    pool[: n // 8] >>= np.uint64(32)  # high 32 bits zero: fingerprint 0 -> 1
    pool[n // 8 : n // 4] |= np.uint64(1 << 63)  # >= 2^63
    return pool


def _staged(layout, *args) -> torch.Tensor:
    """A call's inputs packed through a CPU staging ring into a CPU
    'static' buffer of `layout`: what a graph reads."""
    static = torch.zeros(layout.nbytes, dtype=torch.uint8)
    graphs.StagingRing(layout.nbytes, pin=False).upload(layout, static, *args)
    return static


def _install_cols(rng, pool, n: int, full: bool):
    """One padded install chunk of n rows over the pool (duplicates: the
    last wins), in InstallLayout's column order, numpy."""
    kh = pool[rng.integers(0, pool.shape[0], n)]
    head = (
        (kh, np.uint64),
        (rng.integers(-5, 2000, n).astype(np.int32), np.int32),
        (rng.integers(-5, 2000, n).astype(np.int32), np.int32),
        (rng.integers(0, 2**30, n).astype(np.int32), np.int32),
    )
    if full:
        return pad_to_bucket(
            BUCKETS, n, *head,
            (rng.choice([0, 1, 1000, 60_000, (1 << 30) - 1], n).astype(np.int32), np.int32),
            (rng.integers(-(2**31), 2**31, n).astype(np.int32), np.int32),
            (rng.integers(0, 1 << 6, n).astype(np.int32), np.int32),
        )
    return pad_to_bucket(BUCKETS, n, *head, (rng.random(n) < 0.3, bool))


def _sync_request(rng, pool, n: int):
    """A GLOBAL step's padded sorted request (hits 0 on peeks)."""
    kh = pool[rng.choice(pool.shape[0], n, replace=False)]
    hits = rng.choice([0, 0, 1, 2, 7, 2**40], n)
    limit = rng.choice([0, 1, 5, 30, 1000, -3], n)
    duration = rng.choice([1, 100, 60_000, (1 << 30) - 1], n)
    algo = rng.integers(0, 4, n).astype(np.int32)
    req, _order = pad_request_sorted(extend_ladder(BUCKETS, n), STORE["slots"], kh, hits,
                                     limit, duration, algo, np.zeros(n, bool))
    return req


def _t(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("split", [False, True], ids=["one_device", "two_devices"])
def test_mesh_programs_match_the_jax_mesh_collectives(n_shards, split):
    """The mesh's install, GLOBAL step and read programs from staged
    layouts against the JAX mesh's jitted `_upsert`, `_upsert_full`,
    `_sync`, `_rows_sharded` / `_rows_coll` and `_sketch_min_sharded` /
    `_sketch_min_coll`, step for step on one evolving state: every
    shard's store bytes after each install and step, the step's summed
    answers, each read's rows and estimates. `split` runs the shards as
    two devices: each device's charge part, their sum, then each
    device's install reading the sum (the card's graphs across devices
    or processes); otherwise one device runs charge, sum and install."""
    rng = np.random.default_rng(100 + 10 * n_shards + split)
    pool = _key_pool(rng, 300)
    j = jsh.MeshEngine(JStoreConfig(**STORE), devices=jax.devices()[:n_shards], buckets=BUCKETS)
    Ps, P0 = j.policy.request_spec(), j.policy.replicated_spec()
    coll = lambda fn: jax.jit(shard_map_compat(  # noqa: E731  what a spanning mesh jits
        functools.partial(fn, axes=j.axes), mesh=j.mesh, in_specs=(Ps, P0, P0),
        out_specs=P0, check=False))
    rows_coll, sketch_min_coll = coll(jsh._shard_rows), coll(jsh._shard_sketch_min)
    stores = [tstore.new_store(tstore.StoreConfig(**STORE), CPU) for _ in range(n_shards)]
    groups = [list(range(n_shards // 2)), list(range(n_shards // 2, n_shards))] if split \
        else [list(range(n_shards))]
    counters = rng.integers(0, 50, (n_shards, SKETCH["rows"], SKETCH["width"])).astype(np.int32)
    sketches = [Sketch(data=torch.from_numpy(c)) for c in counters]
    ops = ["install", "sync", "install_full", "sync", "install", "sync", "sync", "install_full"]
    answered = 0
    for step, op in enumerate(ops):
        msg = f"{op} step={step} x{n_shards} split={split}"
        if op.startswith("install"):
            full = op == "install_full"
            cols = _install_cols(rng, pool, int(rng.integers(20, 129)), full)
            static = _staged(graphs.InstallLayout(cols[0].shape[0], full), cols)
            views = graphs.InstallLayout(cols[0].shape[0], full).views(static)
            for grp in groups:
                install_program([stores[s] for s in grp], grp, n_shards, views, full)
            j.store = (j._upsert_full if full else j._upsert)(j.store, *cols)
        else:
            req = _sync_request(rng, pool, int(rng.integers(20, 129)))
            now = int(rng.integers(1, 2**20)) + 1000 * step
            layout = graphs.RequestLayout(req.key_hash.shape[0])
            r, t_now = layout.views(_staged(layout, req, np.int32(now)))
            assert t_now.dim() == 0 and int(t_now) == now
            parts = [sync_charge_program([stores[s] for s in grp], grp, n_shards, r, t_now)
                     for grp in groups]
            total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
            fed = total.clone()  # the install graph's static tensor
            for grp in groups:
                sync_install_program([stores[s] for s in grp], grp, n_shards, r, fed)
            j.store, resp = j._sync(j.store, req.key_hash, req.hits, req.limit, req.duration,
                                    req.algo, req.valid, np.int32(now))
            assert total.dtype == torch.int32 and total.shape == (4, req.key_hash.shape[0])
            np.testing.assert_array_equal(total.numpy(), np.stack([np.asarray(x) for x in resp]),
                                          err_msg=f"answers {msg}")
            answered += int((total[0] == 1).sum())
        np.testing.assert_array_equal(np.stack([s.data.numpy() for s in stores]),
                                      np.asarray(j.store.data), err_msg=f"store {msg}")
        # the reads, at a pow2 rung, over keys the steps touched and others
        B = int(rng.choice(READ_RUNGS[:2]))
        kh = pool[rng.integers(0, pool.shape[0], B)]
        rlay = graphs.ReadLayout(B, SKETCH["rows"])
        idx = sketch_indices_np(kh, rng.integers(-1, 5, B), SketchConfig(**SKETCH))
        t_kh, t_idx = rlay.views(_staged(rlay, kh, idx))
        owner = jnp.asarray(owner_of_np(kh, n_shards))
        b = jstore.bucket_index(jnp.asarray(kh), STORE["slots"])
        rows = sum(rows_program([stores[s] for s in grp], grp, n_shards, t_kh, STORE["slots"])
                   for grp in groups)
        want = np.asarray(jsh._rows_sharded(j.store.data, owner, b))
        np.testing.assert_array_equal(rows.numpy(), want, err_msg=f"rows {msg}")
        np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_coll(j.store.data, owner, b)))
        est = sum(sketch_min_program([sketches[s] for s in grp], grp, n_shards, t_kh, t_idx)
                  for grp in groups)
        j_data, j_idx = jnp.asarray(counters), jnp.asarray(idx)
        np.testing.assert_array_equal(
            est.numpy(), np.asarray(jsh._sketch_min_sharded(j_data, owner, j_idx)),
            err_msg=f"estimates {msg}")
        np.testing.assert_array_equal(est.numpy(), np.asarray(sketch_min_coll(j_data, owner,
                                                                               j_idx)))
    assert answered > 0  # some keys came back over the limit
    assert any(s.data.any() for s in stores)


@pytest.mark.parametrize("full", [False, True], ids=["token", "full"])
def test_flat_programs_match_the_jax_jits(full):
    """The flat engine's install and read programs (no owner mask) from
    staged layouts against `upsert_globals_jit` / `upsert_windows_jit`,
    `_rows_flat` and `_sketch_min_flat`: store bytes after each install,
    rows and estimates after it."""
    rng = np.random.default_rng(7 + full)
    pool = _key_pool(rng, 200)
    cfg = JStoreConfig(**STORE)
    jst = jstore.new_store(cfg)
    store = tstore.new_store(tstore.StoreConfig(**STORE), CPU)
    counters = rng.integers(0, 2**40, (SKETCH["rows"], SKETCH["width"])).astype(np.int64)
    sketch = Sketch(data=torch.from_numpy(counters))
    for step in range(6):
        cols = _install_cols(rng, pool, int(rng.integers(10, 129)), full)
        lay = graphs.InstallLayout(cols[0].shape[0], full)
        install_program([store], None, 1, lay.views(_staged(lay, cols)), full)
        jst = (jk.upsert_windows_jit if full else jk.upsert_globals_jit)(jst, *cols)
        np.testing.assert_array_equal(store.data.numpy(), np.asarray(jst.data),
                                      err_msg=f"store step {step}")
        B = READ_RUNGS[step % 3]
        kh = pool[rng.integers(0, pool.shape[0], B)]
        idx = sketch_indices_np(kh, rng.integers(0, 9, B), SketchConfig(**SKETCH))
        rlay = graphs.ReadLayout(B, SKETCH["rows"])
        t_kh, t_idx = rlay.views(_staged(rlay, kh, idx))
        b = jstore.bucket_index(jnp.asarray(kh), STORE["slots"])
        np.testing.assert_array_equal(
            rows_program([store], None, 1, t_kh, STORE["slots"]).numpy(),
            np.asarray(jsh._rows_flat(jst.data, b)), err_msg=f"rows step {step}")
        np.testing.assert_array_equal(
            sketch_min_program([sketch], None, 1, t_kh, t_idx).numpy(),
            np.asarray(jsh._sketch_min_flat(jnp.asarray(counters), jnp.asarray(idx))))
    assert store.data.any()


def _as_t(x_u64):
    return torch.from_numpy(np.ascontiguousarray(x_u64, np.uint64).view(np.int64)).clone()


@pytest.mark.parametrize("K", [64, 512])
def test_topk_fold_through_its_layout_matches_the_jax_jit(K):
    """The promoter's fold reading a staged TopKLayout (OBSERVE_TOP rows,
    as DeviceTopK's graph does) against the reference's jitted
    `_topk_update`, fold for fold: the table's keys and counts."""
    rng = np.random.default_rng(K)
    B = tp.OBSERVE_TOP
    pool = _key_pool(rng, K // 2 + 40)
    t_kh, t_cnt = torch.zeros(K, dtype=torch.int64), torch.zeros(K, dtype=torch.int64)
    j_kh, j_cnt = jnp.zeros(K, jnp.uint64), jnp.zeros(K, jnp.int64)
    fold = jp._topk_update_jit()
    lay = graphs.TopKLayout(B)
    for step in range(8):
        n = int(rng.integers(1, B + 1))
        kb = np.zeros(B, np.uint64)
        wb = np.zeros(B, np.int64)
        kb[:n] = pool[rng.integers(0, pool.shape[0], n)]
        wb[:n] = rng.choice([0, 1, 1, 2, 3, 50], n)
        got = tp._topk_update(t_kh, t_cnt, *lay.views(_staged(lay, kb.view(np.int64), wb)))
        assert got[0] is t_kh and got[1] is t_cnt
        j_kh, j_cnt = fold(j_kh, j_cnt, jnp.asarray(kb), jnp.asarray(wb))
        np.testing.assert_array_equal(t_kh.numpy().view(np.uint64), np.asarray(j_kh),
                                      err_msg=f"keys step {step}")
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt), err_msg=f"step {step}")
    assert (t_cnt.numpy() > 0).sum() > 8


@pytest.mark.parametrize("full", [False, True])
def test_program_layouts_round_trip_through_the_staging_ring(full):
    """Each new layout's call packed through a CPU staging ring reads
    back field for field through its views (uint64 key hashes as int64
    bit patterns, `now` a 0-d int32), every field 8-byte aligned, and a
    call of the wrong shape or dtype is refused."""
    rng = np.random.default_rng(3 + full)
    pool = _key_pool(rng, 200)
    for n in (17, 64, 100):
        cols = _install_cols(rng, pool, n, full)
        lay = graphs.InstallLayout(cols[0].shape[0], full)
        assert all(off % 8 == 0 for *_f, off in lay.fields)
        for want, got in zip(cols, lay.views(_staged(lay, cols))):
            np.testing.assert_array_equal(got.numpy(), _t(want).numpy())
        req = _sync_request(rng, pool, n)
        rl = graphs.RequestLayout(req.key_hash.shape[0])
        r, now = rl.views(_staged(rl, req, np.int32(n * 1000)))
        assert now.dim() == 0 and int(now) == n * 1000
        for name in req._fields:
            np.testing.assert_array_equal(getattr(r, name).numpy(),
                                          _t(getattr(req, name)).numpy())
        B = 1 << (n - 1).bit_length()
        kh = pool[rng.integers(0, pool.shape[0], B)]
        idx = rng.integers(0, 1 << 20, (3, B))
        for rows in (0, 3):
            rd = graphs.ReadLayout(B, rows)
            got_kh, got_idx = rd.views(_staged(rd, kh, idx if rows else None))
            np.testing.assert_array_equal(got_kh.numpy(), kh.view(np.int64))
            if rows:
                np.testing.assert_array_equal(got_idx.numpy(), idx)
            else:
                assert got_idx is None
    with pytest.raises(ValueError, match="the layout wants"):
        graphs.InstallLayout(64, full).pack(np.zeros(1 << 16, np.uint8),
                                            _install_cols(rng, pool, 100, full))


def _walk_spies(monkeypatch, eng, seen: list, port: bool):
    """Stand-ins for an engine's decide dispatch (answers all zeros) and
    for the entry points of its install, GLOBAL step and read programs,
    each recording (program, rung) and answering with the right shape."""
    mesh = not getattr(eng, "flat", not isinstance(eng, MeshEngine))
    n = eng.n

    def dispatch(req, groups, *a, **k):
        b = req.key_hash.shape[-1]
        if port:
            if mesh:
                return [(slice(0, n), torch.zeros((n, 4 * b + 4), dtype=torch.int32))], {}
            return torch.zeros(4 * b + 4, dtype=torch.int32), None
        return np.zeros((n, 4 * b + 4) if mesh else 4 * b + 4, np.int32)

    monkeypatch.setattr(eng, "_dispatch", dispatch)
    rows = lambda B: np.zeros((B, WAYS, 8), np.int32)  # noqa: E731
    if port:
        monkeypatch.setattr(eng, "_install_chunk", lambda cols, full: seen.append(
            ("install_full" if full else "install", cols[0].shape[0])))

        def gather(kh):
            seen.append(("rows", kh.shape[0]))
            return rows(kh.shape[0]), np.ones(kh.shape[0], np.int32)

        def smin(kh, idx):
            seen.append(("sketch_min", kh.shape[0]))
            return torch.zeros(kh.shape[0], dtype=torch.int32)

        monkeypatch.setattr(eng, "_gather_entries", gather)
        monkeypatch.setattr(eng, "_sketch_min", smin)
        if mesh:
            def sync(key_hash, *a):
                seen.append(("sync", choose_bucket(extend_ladder(eng.buckets, key_hash.shape[0]),
                                                   key_hash.shape[0])))
            monkeypatch.setattr(eng, "_sync_padded", sync)
        return
    monkeypatch.setattr(eng, "_upsert_padded", lambda h, *a: seen.append(("install", h.shape[0])))
    monkeypatch.setattr(eng, "_upsert_full_padded",
                        lambda h, *a: seen.append(("install_full", h.shape[0])))

    def j_gather(kh):
        seen.append(("rows", kh.shape[0]))
        return rows(kh.shape[0])

    def j_smin(name):
        def fn(data, *a):
            idx = a[-1]
            seen.append(("sketch_min", idx.shape[1]))
            return np.zeros(idx.shape[1], np.int64)
        monkeypatch.setattr(jsh, name, fn)

    monkeypatch.setattr(eng, "_gather_entries", j_gather)
    j_smin("_sketch_min_flat")
    j_smin("_sketch_min_sharded")
    if mesh:
        def j_sync(key_hash, *a):
            seen.append(("sync", choose_bucket(extend_ladder(eng.buckets, key_hash.shape[0]),
                                               key_hash.shape[0])))
        monkeypatch.setattr(eng, "_sync_padded", j_sync)


@pytest.mark.parametrize("ladder", [buckets_for_limit(32768), DEFAULT_BUCKETS],
                         ids=["limit_32768", "default"])
@pytest.mark.parametrize("n_shards", [0, 2, 4], ids=["flat", "2_shards", "4_shards"])
def test_warmups_walk_every_program_rung_serving_needs(n_shards, ladder, monkeypatch):
    """The port's warmups run its install, GLOBAL step and read programs
    at exactly the rungs the JAX warmups compile theirs, and those are
    what serving needs: the token install at every host rung (GLOBAL
    broadcasts, promotions), on a mesh the GLOBAL step at every host
    rung, and with a sketch both reads at every READ_RUNGS rung (the
    promoter's). No full-lane install: restores capture it on first use,
    as the reference compiles it."""
    sk = dict(rows=2, width=1 << 10)
    if n_shards:
        j = jsh.MeshEngine(JStoreConfig(rows=4, slots=64), devices=jax.devices()[:n_shards],
                           buckets=ladder, sketch=JSketchConfig(**sk))
        t = MeshEngine(tstore.StoreConfig(rows=4, slots=64), devices=["cpu"] * n_shards,
                       buckets=ladder, sketch=SketchConfig(sk["rows"], sk["width"], 4))
    else:
        j = TpuEngine(JStoreConfig(rows=4, slots=64), buckets=ladder, sketch=JSketchConfig(**sk))
        t = TorchEngine(tstore.StoreConfig(rows=4, slots=64), buckets=ladder, device="cpu",
                        sketch=SketchConfig(sk["rows"], sk["width"], 4))
    j_seen: list = []
    t_seen: list = []
    _walk_spies(monkeypatch, j, j_seen, False)
    _walk_spies(monkeypatch, t, t_seen, True)
    j.warmup(now=T0)
    t.warmup(now=T0)
    need = {("install", b) for b in ladder}
    need |= {(p, B) for p in ("rows", "sketch_min") for B in READ_RUNGS}
    if n_shards:
        need |= {("sync", b) for b in ladder}
    assert set(t_seen) == set(j_seen) == need, (sorted(set(t_seen) ^ need),
                                                sorted(set(j_seen) ^ need))
