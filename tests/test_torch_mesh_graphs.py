"""The mesh's graph inputs and warmup walk against the JAX package.

On the card a mesh decides a batch as one captured CUDA graph a device,
whose `k` rows are the shards on that device (core/graphs.py,
MeshEngine.device_graphs): it reads every shard's sub-batch from one
static byte buffer laid out by `DecideLayout(B_sub, G_sub, chain, k)`,
with `now` a 0-d int32 tensor there, and writes one packed [k,
4*B_sub+4] output. On the CPU the same layout, staging ring and
`decide_rows` run eagerly, so these tests hold that input path against
the JAX mesh's jitted shard_map programs `_step`, `_step_sketch` and
`_step_chain` (gubernator_tpu/parallel/sharded.py:990-1043) from the
same seeded numpy inputs: responses, stats, every shard's store and
sketch bytes identical (tolerance zero: integer math), on 2 and 4
shards. They also hold the mesh warmup's (B_sub, G_sub) walk against
the JAX `warmup_public`'s (gubernator_tpu/parallel/sharded.py:2302-2350)
on 2, 4 and 8 shards (the 8 simulated CPU devices of tests/conftest.py).
Capture and replay themselves need the card: tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.parallel.sharded import MeshEngine as JMeshEngine
from gubernator_tpu_torch.core import graphs
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import DEFAULT_BUCKETS, TorchEngine, buckets_for_limit
from gubernator_tpu_torch.core.sketches import SketchConfig, new_sketch
from gubernator_tpu_torch.parallel.policy import ShardingPolicy
from gubernator_tpu_torch.parallel.sharded import (
    MeshEngine,
    group_rungs,
    owner_of_np,
    pad_request_chained,
    pad_request_sharded,
    sub_batch_ladder,
)

CPU = torch.device("cpu")
T0 = 1_700_000_000_000
BUCKETS = (64, 128)  # sub-batch rungs 64, 96, 128
STORE = dict(rows=4, slots=16)  # small: drops and evictions
SKETCH = dict(rows=2, width=1 << 8)


def _key_pool(rng, n: int) -> np.ndarray:
    pool = rng.integers(0, 2**64, n, dtype=np.uint64)
    pool[: n // 8] >>= np.uint64(32)  # high 32 bits zero: fingerprint 0 -> 1
    pool[n // 8 : n // 4] |= np.uint64(1 << 63)  # >= 2^63
    return pool


def _fields(rng, keys, n: int) -> dict:
    """n rows over `keys`: all four algorithms mixed a row (a group's
    rows disagree), zipf-ish picks, peeks, oversized hits, zero and
    negative limits, durations at the int32 envelope's edge."""
    distinct = keys.shape[0]
    idx = np.minimum(rng.zipf(1.3, n) - 1, distinct - 1)
    idx = np.where(rng.random(n) < 0.5, idx, rng.integers(0, distinct, n))
    return dict(
        key_hash=keys[idx],
        hits=rng.choice([0, 1, 1, 1, 2, 5, 40, -3, 2**40], n),
        limit=rng.choice([0, 1, 3, 8, 30, 1000, -5, 2**31 - 1, 2**33], n),
        duration=rng.choice([1, 100, 1000, 60_000, (1 << 30) - 1, (1 << 30) + 9, -50], n),
        algo=rng.integers(0, 4, n).astype(np.int32),
        gnp=rng.random(n) < 0.1,
    )


def _sharded(rng, pool, n_shards: int, step: int, chain: bool):
    """One sharded batch, [n_shards, B_sub] numpy (copies: the native
    prep's arrays are views into its ring): (req, groups, chain_id).
    Each shard gets its own count of rows over at most 60 of the keys it
    owns: 30-63 rows on even steps (B_sub 64), 99-126 on odd ones
    (B_sub 128 over the compact group rung 64). Chained batches route
    chains of 3 of those rows by their heads."""
    owners = owner_of_np(pool, n_shards)
    lo, hi = ((10, 21), (33, 42))[step % 2]  # chains of 3 (plain rows: x3)
    parts = []
    for s in range(n_shards):
        own = pool[owners == s]
        keys = own[rng.choice(own.shape[0], min(60, own.shape[0]), replace=False)]
        parts.append(_fields(rng, keys, 3 * int(rng.integers(lo, hi))))
    f = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    perm = rng.permutation(f["key_hash"].shape[0])
    ladder = sub_batch_ladder(BUCKETS)
    if chain:
        # the batch in chain order: rows 3c..3c+2 are chain c, routed by
        # its head, the first; each level keeps its own key (one of the
        # head shard's) for its bucket
        heads = f["key_hash"][::3]
        cid = np.arange(f["key_hash"].shape[0]) // 3
        req, _o, _t, groups, chain_local = pad_request_chained(
            ladder, STORE["slots"], n_shards, f["key_hash"], f["hits"], f["limit"],
            f["duration"], f["algo"], cid, heads[cid],
        )
    else:
        f = {k: v[perm] for k, v in f.items()}
        req, _o, _t, groups = pad_request_sharded(
            ladder, STORE["slots"], n_shards, f["key_hash"], f["hits"], f["limit"],
            f["duration"], f["algo"], f["gnp"], with_groups=True,
        )
        chain_local = None
    copy = lambda b: type(b)(*(np.array(x) for x in b))  # noqa: E731
    return copy(req), copy(groups), None if chain_local is None else np.array(chain_local)


def _staged(program: str, req, groups, now: int, chain_id):
    """What a device's graph of `program` reads: the sharded batch packed
    through a staging slot into a static byte buffer, as each row's
    tensor views."""
    k, B = req.key_hash.shape
    layout = graphs.DecideLayout(B, groups.key_hash.shape[1], program == "chain", k)
    static = torch.zeros(layout.nbytes, dtype=torch.uint8)
    graphs.StagingRing(layout.nbytes, pin=False).upload(
        layout, static, req, groups, np.int32(now), chain_id
    )
    return layout.rows(static)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("chain", [False, True])
def test_device_layout_packs_and_views_a_sharded_batch_byte_for_byte(n_shards, chain):
    """A sharded batch packed through a CPU staging ring into a k-row
    layout's buffer reads back, row by row, as each shard's sub-batch
    (uint64 key hashes as int64 bit patterns), `now` one 0-d int32 every
    row shares; every field 8-byte aligned; k = 1 is the flat layout
    byte for byte."""
    rng = np.random.default_rng(40 + n_shards + chain)
    pool = _key_pool(rng, 600)
    for step in range(3):
        req, groups, chain_id = _sharded(rng, pool, n_shards, step, chain)
        now = int(rng.integers(0, 2**30))
        k, B = req.key_hash.shape
        G = groups.key_hash.shape[1]
        layout = graphs.DecideLayout(B, G, chain, k)
        assert k == n_shards and all(off % 8 == 0 for *_f, off in layout.fields)
        rows = _staged("chain" if chain else "exact", req, groups, now, chain_id)
        for s, (r, g, t_now, c) in enumerate(rows):
            for want, got in ((req, r), (groups, g)):
                for name in want._fields:
                    w = np.asarray(getattr(want, name))[s]
                    w = w.view(np.int64) if w.dtype == np.uint64 else w
                    np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                                  err_msg=f"shard {s} {name}")
            assert t_now.dim() == 0 and int(t_now) == now
            if chain:
                np.testing.assert_array_equal(c.numpy(), chain_id[s])
            else:
                assert c is None
        # one row of a k-row batch packs as the flat layout does
        flat, one = graphs.DecideLayout(B, G, chain), graphs.DecideLayout(B, G, chain, 1)
        assert flat.fields == one.fields and flat.nbytes == one.nbytes
        a, b = np.zeros(flat.nbytes, np.uint8), np.zeros(flat.nbytes, np.uint8)
        row0 = lambda x: type(x)(*(y[0] for y in x))  # noqa: E731
        c0 = None if chain_id is None else chain_id[0]
        flat.pack(a, row0(req), row0(groups), np.int32(now), c0)
        one.pack(b, type(req)(*(y[:1] for y in req)), type(groups)(*(y[:1] for y in groups)),
                 np.int32(now), None if chain_id is None else chain_id[:1])
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="the layout wants"):
        graphs.DecideLayout(B, G, chain, k + 1).pack(
            np.zeros(graphs.DecideLayout(B, G, chain, k + 1).nbytes, np.uint8),
            req, groups, np.int32(0), chain_id)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("program", ["exact", "sketch", "chain"])
def test_mesh_programs_through_the_layout_match_the_jax_mesh_steps(program, n_shards):
    """Every shard decided by `decide_rows` from the device layout's row
    views (`now` a 0-d tensor) against the JAX mesh's jitted step of the
    same program on the same [n_shards, B_sub] batch and `now`, batch
    for batch: the packed [n_shards, 4*B_sub+4] output, every shard's
    store and sub-sketch bytes identical; sub-batch rungs 64 to 128 with
    a compact group rung, stores small enough to drop and evict."""
    rng = np.random.default_rng({"exact": 1, "sketch": 2, "chain": 3}[program] * 10 + n_shards)
    pool = _key_pool(rng, 600)
    sk = program == "sketch"
    j = JMeshEngine(JStoreConfig(**STORE), devices=jax.devices()[:n_shards], buckets=BUCKETS,
                    sketch=JSketchConfig(**SKETCH) if sk else None)
    stores = [tstore.new_store(tstore.StoreConfig(**STORE), CPU) for _ in range(n_shards)]
    sketches = [new_sketch(SketchConfig(**SKETCH), CPU) if sk else None
                for _ in range(n_shards)]
    now = 1
    totals = np.zeros(4, np.int64)
    shapes = set()
    for step in range(6):
        now += int(rng.choice([0, 1, 3, 50, 400, 5000, 70_000]))
        req, groups, chain_id = _sharded(rng, pool, n_shards, step, program == "chain")
        B_sub = req.key_hash.shape[1]
        shapes.add((B_sub, groups.key_hash.shape[1]))
        got = graphs.decide_rows(program, stores, sketches,
                                 _staged(program, req, groups, now, chain_id))
        j_now = np.int32(now)
        if program == "exact":
            j.store, want = j._step(j.store, req, groups, j_now)
        elif program == "sketch":
            j.store, j.sketch, want = j._step_sketch(j.store, j.sketch, req, groups, j_now)
        else:
            j.store, want = j._step_chain(j.store, req, groups, chain_id, j_now)
        want = np.asarray(want)
        msg = f"{program} x{n_shards} step={step}"
        assert got.shape == (n_shards, 4 * B_sub + 4)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"packed {msg}")
        np.testing.assert_array_equal(np.stack([s.data.numpy() for s in stores]),
                                      np.asarray(j.store.data), err_msg=f"store {msg}")
        if sk:
            np.testing.assert_array_equal(np.stack([s.data.numpy() for s in sketches]),
                                          np.asarray(j.sketch.data), err_msg=f"sketch {msg}")
        totals += want[:, 4 * B_sub:].sum(axis=0)
    # the stream reached what it is meant to cover
    assert shapes == {(64, 64), (128, 64)}, shapes
    assert totals[0] > 0 and totals[1] > 0  # live hits and creations
    assert totals[2] > 0  # dropped creates (sketch-served on the two tiers)
    if sk:
        assert any(s.data.any() for s in sketches)


def _spy(seen: list, engine, port: bool):
    """A stand-in for a mesh engine's _dispatch that records each batch's
    (B_sub, G_sub) (and, on the port, the tier) and answers all zeros."""

    def dispatch(req, groups, e_now, *args, **kwargs):
        n, b = req.key_hash.shape
        g = groups.key_hash.shape[1]
        if port:
            seen.append((b, g, bool(engine.sketch_on)))
            return [(slice(0, n), torch.zeros((n, 4 * b + 4), dtype=torch.int32))], {}
        seen.append((b, g))
        return np.zeros((n, 4 * b + 4), np.int32)

    return dispatch


@pytest.mark.parametrize("ladder", [buckets_for_limit(32768), DEFAULT_BUCKETS],
                         ids=["limit_32768", "default"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mesh_warmup_walks_the_jax_mesh_warmups_rungs(n_shards, ladder, monkeypatch):
    """The port's mesh warmup decides exactly the (B_sub, G_sub) pairs the
    JAX mesh's warmup_public compiles, every (r, g in group_rungs(r)) of
    the sub-batch ladder, each with the exact and (a sketch configured)
    the two-tier program: the set a device captures one graph each."""
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    j = JMeshEngine(JStoreConfig(rows=4, slots=64), devices=jax.devices()[:n_shards],
                    buckets=ladder)
    j_seen: list = []
    monkeypatch.setattr(j, "_dispatch", _spy(j_seen, j, False))
    for name in ("update_globals", "sync_globals"):
        monkeypatch.setattr(j, name, lambda *a, **k: None)
    j.warmup(now=T0)
    t = MeshEngine(tstore.StoreConfig(rows=4, slots=64), devices=["cpu"] * n_shards,
                   buckets=ladder, sketch=SketchConfig(2, 1 << 10, 4))
    t_seen: list = []
    monkeypatch.setattr(t, "_dispatch", _spy(t_seen, t, True))
    for name in ("update_globals", "sync_globals", "_warmup_sketch_reads"):
        monkeypatch.setattr(t, name, lambda *a, **k: None)
    t.warmup(now=T0)
    pairs = {(r, g) for r in t.sub_buckets for g in group_rungs(r)}
    assert tuple(j.sub_buckets) == t.sub_buckets
    assert set(j_seen) == pairs and len(j_seen) == len(pairs)
    assert sorted(t_seen) == sorted((b, g, on) for b, g in pairs for on in (False, True))
    assert t.sketch_on  # restored after the walk


def test_mesh_warmup_leaves_counters_and_state_zeroed():
    """A real mesh warmup on the CPU (4 shards, a small ladder, two
    tiers): every pair decided once a program, then every shard's store
    and sub-sketch and every counter zeroed; warmup_launches counts what
    a GPU would have launched (n_shards a decide, an install or a gossip
    chunk); a CPU mesh holds no graphs."""
    cfg = tstore.StoreConfig(rows=4, slots=64)
    t = MeshEngine(cfg, devices=["cpu"] * 4, buckets=BUCKETS, sketch=SketchConfig(2, 1 << 10, 4))
    t.warmup(now=T0)
    pairs = sum(len(group_rungs(r)) for r in sub_batch_ladder(BUCKETS))
    # each host rung: one replica install (update_globals), one sync (a
    # gossip chunk and an install chunk), and the promoter reads' installs
    probe = MeshEngine(cfg, devices=["cpu"] * 4, buckets=BUCKETS, sketch=SketchConfig(2, 1 << 10, 4))
    for b in BUCKETS:
        k = np.arange(1, b + 1, dtype=np.uint64) << np.uint64(32)
        ones = np.ones(b, np.int64)
        probe.update_globals(key_hash=k, limit=ones, remaining=ones, reset_time=ones * T0,
                             is_over=np.zeros(b, bool), now=T0)
        probe.sync_globals(k, ones, ones * 1000, now=T0)
    probe._warmup_sketch_reads(T0)
    chunks = probe.install_chunks + probe.gossip_chunks
    assert t.warmup_launches == 4 * (2 * pairs + chunks)
    assert not t.store_numpy().any() and not t.sketch_numpy().any()
    assert t.stats.snapshot() == dict(hits=0, misses=0, batches=0, dropped=0, evictions=0)
    assert t.install_chunks == t.gossip_chunks == 0
    assert t.device_graphs == {} and t.graphs is None
    assert (t.graph_count, t.graph_captures, t.graph_pool_bytes, t.capture_s) == (0, 0, 0, 0.0)
    assert t.sketch_on
    t.close()
    assert t.device_graphs == {}


@pytest.mark.parametrize("cuda_graphs", [True, False])
def test_repartition_carries_cuda_graphs_into_a_mesh_engine(cuda_graphs):
    """repartition hands its `cuda_graphs` to the engine it builds, flat
    -> mesh -> mesh -> flat, and every step carries the live windows."""
    cfg = tstore.StoreConfig(rows=4, slots=64)
    flat = TorchEngine(cfg, buckets=BUCKETS, device="cpu", cuda_graphs=cuda_graphs)
    kh = np.arange(1, 101, dtype=np.uint64) << np.uint64(32)
    one = np.ones(100, np.int64)
    flat.decide_arrays(kh, one, one * 5, one * 60_000, np.zeros(100, np.int32),
                       np.zeros(100, bool), T0)
    eng = flat
    for policy in (ShardingPolicy.over_mesh(["cpu"] * 4), ShardingPolicy.over_mesh(["cpu"] * 2),
                   ShardingPolicy.single("cpu")):
        nxt = eng.repartition(policy, now=T0 + 1)
        assert type(nxt) is (TorchEngine if policy.flat else MeshEngine)
        assert nxt.cuda_graphs is cuda_graphs and nxt.graph_count == 0
        assert nxt.snapshot_read(kh, T0 + 1) == flat.snapshot_read(kh, T0 + 1)
        eng.close()
        eng = nxt
