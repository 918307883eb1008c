"""The port's graph inputs and warmup walk against the JAX package.

On the card each (program, B, G) decide is a captured CUDA graph that
reads its batch from one static byte buffer (core/graphs.py): `now` a
0-d int32 tensor there, the request and group columns views of it. On
the CPU the same layout, staging ring and program functions run
eagerly, so these tests hold that input path against the JAX package's
jitted programs (`_decide_packed_jit`, `_decide_packed_sketch_jit`,
`_decide_packed_chain_jit`, gubernator_tpu/core/engine.py:72-101) from
the same numpy inputs (made from a seed): responses, stats, store and
sketch bytes identical (tolerance zero: integer math). They also hold
the warmup's (B, G) walk against the JAX warmup's
(gubernator_tpu/parallel/sharded.py:2270-2284). Graph capture and
replay themselves need the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import store as jstore
from gubernator_tpu.core.engine import TpuEngine
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu_torch.core import graphs
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import (
    DEFAULT_BUCKETS,
    TorchEngine,
    _np_presort_grouped,
    build_groups,
    buckets_for_limit,
    group_rungs,
    pad_request_sorted,
)
from gubernator_tpu_torch.core.sketches import Sketch, SketchConfig

CPU = torch.device("cpu")
B = 256
T0 = 1_700_000_000_000


def _key_pool(rng, n: int) -> np.ndarray:
    pool = rng.integers(0, 2**64, n, dtype=np.uint64)
    pool[: n // 8] >>= np.uint64(32)  # high 32 bits zero: fingerprint 0 -> 1
    pool[n // 8 : n // 4] |= np.uint64(1 << 63)  # >= 2^63
    return pool


def _batch(rng, pool: np.ndarray, distinct: int):
    """At most B rows over at most `distinct` keys of the pool: all four
    algorithms mixed per row (a group's rows disagree), zipf-ish picks
    (duplicate-key groups), peeks, oversized hits, zero and negative
    limits, durations at the int32 envelope's edge."""
    n = int(rng.integers(distinct // 2, B + 1))
    keys = pool[rng.choice(pool.shape[0], distinct, replace=False)]
    idx = np.minimum(rng.zipf(1.3, n) - 1, distinct - 1)
    idx = np.where(rng.random(n) < 0.5, idx, rng.integers(0, distinct, n))
    return dict(
        key_hash=keys[idx],
        hits=rng.choice([0, 1, 1, 1, 2, 5, 40, -3, 2**40], n),
        limit=rng.choice([0, 1, 3, 8, 30, 1000, -5, 2**31 - 1, 2**33], n),
        duration=rng.choice(
            [1, 100, 1000, 60_000, (1 << 30) - 1, (1 << 30) + 9, -50], n
        ),
        algo=rng.integers(0, 4, n).astype(np.int32),
        gnp=rng.random(n) < 0.1,
    )


def _pad(fields, buckets: int, G: int):
    """The presorted batch at B rows and a G rung of its group slots."""
    req, _order = pad_request_sorted(
        (B,), buckets, fields["key_hash"], fields["hits"], fields["limit"],
        fields["duration"], fields["algo"], fields["gnp"],
    )
    n = fields["key_hash"].shape[0]
    _o, gid, lpos, G_real = _np_presort_grouped(fields["key_hash"], buckets)
    assert G_real <= G
    return req, build_groups(req.key_hash, gid, lpos, G_real, n, B, G)


def _staged(program: str, req, groups, now: int, chain_id):
    """What a graph of `program` reads: the batch packed through a
    staging slot into a static byte buffer, as tensor views of it."""
    layout = graphs.DecideLayout(B, groups.key_hash.shape[0], program == "chain")
    static = torch.zeros(layout.nbytes, dtype=torch.uint8)
    graphs.StagingRing(layout.nbytes, pin=False).upload(
        layout, static, req, groups, np.int32(now), chain_id
    )
    return layout.views(static)


@pytest.mark.parametrize("program", ["exact", "sketch", "chain"])
def test_tensor_now_programs_match_the_jax_programs(program):
    """Each program fed from the static buffer (`now` a 0-d tensor)
    against its jitted JAX program at the same `now`, batch for batch:
    G = B and G = 64 < B rungs, a store small enough to drop and evict,
    a rebase forced mid-stream with the next batch just after it, and
    `now` just below the rebase threshold with durations at the int32
    envelope's edge (now + duration = 2^31 - 2)."""
    rng = np.random.default_rng({"exact": 1, "sketch": 2, "chain": 3}[program])
    buckets, rows = 16, 16
    pool = _key_pool(rng, 600)
    j_store = jstore.Store(data=jnp.zeros((buckets, rows * tstore.LANES), jnp.int32))
    t_store = tstore.new_store(tstore.StoreConfig(rows=rows, slots=buckets), CPU)
    sk0 = np.zeros((2, 1 << 8), np.int32)
    j_sk = jk.Sketch(data=jnp.asarray(sk0))
    t_sk = Sketch(data=torch.from_numpy(sk0.copy()))
    now, rebases, small_g, edge = 1, 0, 0, 0
    totals = np.zeros(4, np.int64)
    for step in range(24):
        now += int(rng.choice([0, 1, 3, 50, 400, 5000, 70_000, 1 << 27]))
        if step == 16:
            now = jstore.REBASE_AT - 1  # the last ms before a rebase
            edge += 1
        if now > jstore.REBASE_AT or step == 17:
            # the engine's epoch rebase: the store shifts, the sketch clears
            delta = now - 1
            j_store = jk.rebase_jit(j_store, jnp.int32(delta))
            j_sk = jk.Sketch(data=jnp.zeros_like(j_sk.data))
            tstore.rebase(t_store, delta)
            t_sk.data.zero_()
            now, rebases = 1, rebases + 1
        G = 64 if step % 2 else B
        small_g += G < B
        req, groups = _pad(_batch(rng, pool, 64 if G < B else 300), buckets, G)
        chain_id = (np.arange(B) // 4).astype(np.int32) if program == "chain" else None
        t_req, t_groups, t_now, t_chain = _staged(program, req, groups, now, chain_id)
        assert t_now.dim() == 0 and t_now.dtype == torch.int32
        got = graphs.PROGRAMS[program](t_store, t_sk, t_req, t_groups, t_now, t_chain)
        j_now = jnp.int32(now)
        if program == "exact":
            j_store, want = jengine._decide_packed_jit(j_store, req, j_now, groups)
        elif program == "sketch":
            j_store, j_sk, want = jengine._decide_packed_sketch_jit(
                j_store, j_sk, req, j_now, groups
            )
        else:
            j_store, want = jengine._decide_packed_chain_jit(
                j_store, req, j_now, groups, jnp.asarray(chain_id)
            )
        want = np.asarray(want)
        msg = f"{program} step={step}"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"packed {msg}")
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_store.data), err_msg=f"store {msg}"
        )
        np.testing.assert_array_equal(
            t_sk.data.numpy(), np.asarray(j_sk.data), err_msg=f"sketch {msg}"
        )
        totals += want[4 * B :]
    # the stream reached what it is meant to cover
    assert rebases >= 1 and small_g >= 10 and edge == 1
    assert totals[0] > 0 and totals[1] > 0  # live hits and creations
    assert totals[2] > 0  # dropped creates (sketch-served on the two tiers)
    if program != "sketch":
        np.testing.assert_array_equal(t_sk.data.numpy(), sk0)  # never touched


def _spy_dispatch(seen: list, engine, graphs_tier: bool):
    """A stand-in for an engine's _dispatch that records the batch's
    (B, G) (and, on the port, the tier) and answers all zeros."""

    def dispatch(req, groups, e_now, *args, **kwargs):
        b, g = req.key_hash.shape[0], groups.key_hash.shape[0]
        if graphs_tier:
            seen.append((b, g, bool(engine.sketch_on)))
            return torch.zeros(4 * b + 4, dtype=torch.int32), None
        seen.append((b, g))
        return np.zeros(4 * b + 4, np.int32)

    return dispatch


@pytest.mark.parametrize("ladder", [buckets_for_limit(32768), DEFAULT_BUCKETS],
                         ids=["limit_32768", "default"])
def test_warmup_walks_the_jax_warmups_rungs(ladder, monkeypatch):
    """The port's warmup decides exactly the (B, G) pairs the JAX
    warmup compiles, each with the exact and (a sketch configured) the
    two-tier program: the set the card captures one graph each."""
    j = TpuEngine(JStoreConfig(rows=4, slots=64), buckets=ladder)
    j_seen: list = []
    monkeypatch.setattr(j, "_dispatch", _spy_dispatch(j_seen, j, False))
    monkeypatch.setattr(j, "update_globals", lambda *a, **k: None)
    j.warmup(now=T0)
    t = TorchEngine(tstore.StoreConfig(rows=4, slots=64), buckets=ladder, device="cpu",
                    sketch=SketchConfig(2, 1 << 10, 4))
    t_seen: list = []
    monkeypatch.setattr(t, "_dispatch", _spy_dispatch(t_seen, t, True))
    monkeypatch.setattr(t, "install_windows", lambda *a, **k: None)
    t.warmup(now=T0)
    pairs = {(b, g) for b in ladder for g in group_rungs(b)}
    assert set(j_seen) == pairs and len(j_seen) == len(pairs)
    assert sorted(t_seen) == sorted((b, g, on) for b, g in pairs for on in (False, True))
    assert t.sketch_on  # restored after the walk


def test_warmup_leaves_counters_and_state_zeroed():
    """A real warmup on the CPU (default ladder, two tiers): every pair
    decided once a program, one install a rung, then the store, the
    sketch and every counter zeroed; warmup_launches counts what a GPU
    would have launched (a decide or an install chunk each)."""
    t = TorchEngine(tstore.StoreConfig(rows=4, slots=64), device="cpu",
                    sketch=SketchConfig(2, 1 << 10, 4))
    t.warmup(now=T0)
    pairs = sum(len(group_rungs(b)) for b in DEFAULT_BUCKETS)
    assert t.warmup_launches == 2 * pairs + len(DEFAULT_BUCKETS)
    assert not t.store.data.any() and not t.sketch.data.any()
    assert t.stats.snapshot() == dict(hits=0, misses=0, batches=0, dropped=0, evictions=0)
    assert t.install_chunks == t.gossip_chunks == 0
    assert (t.graph_count, t.graph_captures, t.graph_pool_bytes) == (0, 0, 0)
    assert t.sketch_on and t.reset_generation == 1


@pytest.mark.parametrize("chain", [False, True])
def test_staging_ring_round_trips_a_batch_byte_for_byte(chain):
    """Batches of two shapes packed through a CPU staging ring into CPU
    'static' buffers read back byte for byte through the layout's views
    (uint64 key hashes as int64 bit patterns), every field 8-byte
    aligned, the slots taken in turn."""
    rng = np.random.default_rng(7 + chain)
    pool = _key_pool(rng, 600)
    big = graphs.DecideLayout(B, B, True)
    ring = graphs.StagingRing(big.nbytes, pin=False)
    for step, G in enumerate((B, 64, B, 64)):
        req, groups = _pad(_batch(rng, pool, 64 if G < B else 300), 16, G)
        now = np.int32(rng.integers(0, 2**30))
        chain_id = rng.integers(0, B, B).astype(np.int32) if chain else None
        layout = graphs.DecideLayout(B, G, chain)
        assert all(off % 8 == 0 for *_f, off in layout.fields)
        static = torch.full((layout.nbytes,), 0xAB, dtype=torch.uint8)
        ring.upload(layout, static, req, groups, now, chain_id)
        r, g, n, c = layout.views(static)
        for want, got in ((req, r), (groups, g)):
            for name in want._fields:
                w = np.asarray(getattr(want, name))
                w = w.view(np.int64) if w.dtype == np.uint64 else w
                np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)
        assert n.dim() == 0 and int(n) == int(now)
        if chain:
            np.testing.assert_array_equal(c.numpy(), chain_id)
        else:
            assert c is None
        assert ring.depth == 1 and ring.waits == 0
    with pytest.raises(ValueError, match="bytes in a ring"):
        graphs.StagingRing(64, pin=False).upload(
            big, torch.zeros(big.nbytes, dtype=torch.uint8), req, groups, 0, chain_id
        )



def test_collected_graphs_are_retired_not_destroyed_by_the_collector():
    """The graphs of an owner the collector drops (here a reference
    cycle) are not destroyed by the collector, which may run inside
    another engine's capture and would abort it, but kept in the retired
    list until the next safe point (a capture, a close or `synchronize`,
    each under the capture lock) resets each of them once."""
    import gc

    resets = []

    class Entry:
        def __init__(self, name):
            self.graph = self
            self.name = name

        def reset(self):
            resets.append(self.name)

    class Owner:
        pass

    graphs._reset_retired()
    owner = Owner()
    owner.cycle = owner
    owner.graphs = {("exact", 64, 64): Entry("exact"), ("sketch", 64, 64): Entry("sketch")}
    graphs._retire_on_collect(owner, owner.graphs)
    del owner
    gc.collect()
    assert resets == [] and len(graphs._RETIRED) == 1
    with graphs._LOCK:
        graphs._reset_retired()
    assert sorted(resets) == ["exact", "sketch"] and graphs._RETIRED == []
    graphs._reset_retired()
    assert len(resets) == 2
