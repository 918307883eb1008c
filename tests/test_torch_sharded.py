"""The port's mesh engine (parallel/sharded.py MeshEngine) on the CPU: the
cases of tests/test_sharded.py, each a differential against the JAX
package's MeshEngine on the 8 simulated devices tests/conftest.py sets up.

The port's engine holds its 8 shards on the one CPU (`["cpu"] * 8`); every
case feeds both engines the same seeded numpy inputs and asserts identical
responses, store bytes ([n_shards, buckets, W]) and stats, beside the
reference test's own oracle checks: decisions equal the exact oracle, keys
spread over shards, each shard's sub-batch holds only the rows it owns
(the same padded arrays as the JAX prep), a skewed batch past the ladder
top, GLOBAL sync installing replicas on every shard (and a leaky peek not
refilling the owner), compact group rungs, duplicate keys, two batches in
flight, the submit-time epoch, the 2-D ("host", "chip") mesh with its
staged reduction, and chained batches routed whole to their heads' owners.
"""

import random
import re

import jax
import numpy as np
import pytest

from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.parallel.sharded import MeshEngine as JMeshEngine
from gubernator_tpu.parallel.sharded import pad_request_sharded as j_pad_request_sharded
from gubernator_tpu_torch.api.types import Algorithm, RateLimitReq, SECOND, Status
from gubernator_tpu_torch.core.cache import LRUCache
from gubernator_tpu_torch.core.hashing import slot_hash_batch
from gubernator_tpu_torch.core.oracle import get_rate_limit
from gubernator_tpu_torch.core.store import LANES, REBASE_AT, StoreConfig
from gubernator_tpu_torch.parallel.sharded import (
    MeshEngine,
    owner_of_np,
    pad_request_sharded,
)

T0 = 1_700_000_000_000
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def engines():
    assert len(jax.devices()) == 8, "conftest should provide 8 cpu devices"
    t = MeshEngine(StoreConfig(rows=4, slots=1 << 10), devices=CPU8, buckets=(64, 256))
    j = JMeshEngine(JStoreConfig(rows=4, slots=1 << 10), buckets=(64, 256))
    return t, j


@pytest.fixture(autouse=True)
def _reset(engines):
    from gubernator_tpu_torch.core.engine import EngineStats
    from gubernator_tpu.core.engine import EngineStats as JEngineStats

    t, j = engines
    for e, stats in ((t, EngineStats), (j, JEngineStats)):
        e.reset()
        e.stats = stats()
        e.clock.epoch = None
    yield


def arrays_for(reqs):
    n = len(reqs)
    return dict(
        key_hash=slot_hash_batch([r.hash_key() for r in reqs]),
        hits=np.array([r.hits for r in reqs], np.int64),
        limit=np.array([r.limit for r in reqs], np.int64),
        duration=np.array([r.duration for r in reqs], np.int64),
        algo=np.array([int(r.algorithm) for r in reqs], np.int32),
        gnp=np.zeros(n, bool),
    )


def same_out(a, b, ctx=""):
    for name, x, y in zip(("status", "limit", "remaining", "reset"), a, b):
        np.testing.assert_array_equal(
            np.asarray(x, np.int64), np.asarray(y, np.int64), err_msg=f"{ctx} {name}"
        )


def same_state(t, j, ctx=""):
    np.testing.assert_array_equal(
        t.store_numpy(), np.asarray(j.store.data), err_msg=f"{ctx} store"
    )
    assert t.stats.snapshot() == j.stats.snapshot(), ctx


def decide_both(engines, now, **a):
    t, j = engines
    got = t.decide_arrays(now=now, **a)
    same_out(got, j.decide_arrays(now=now, **a), f"now={now}")
    return got


def test_mesh_matches_oracle(engines):
    """Sharded decisions equal the exact oracle, key by key, and the JAX
    mesh's, bytes and stats."""
    rng = random.Random(7)
    cache = LRUCache()
    keys = [f"acct:{i}" for i in range(64)]
    now = T0
    for step in range(40):
        now += rng.choice([0, 3, 17, 120])
        batch_keys = rng.sample(keys, rng.randint(1, 32))
        reqs = [
            RateLimitReq(
                name="mesh", unique_key=k, hits=rng.choice([0, 1, 1, 2, 5]),
                limit=rng.choice([2, 5, 10]), duration=rng.choice([50, 1000]),
                algorithm=rng.choice([Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET]),
            )
            for k in batch_keys
        ]
        status, limit, remaining, reset = decide_both(engines, now, **arrays_for(reqs))
        for i, r in enumerate(reqs):
            want = get_rate_limit(cache, r, now=now)
            got = (status[i], limit[i], remaining[i], reset[i])
            assert got == (int(want.status), want.limit, want.remaining, want.reset_time), (
                f"step={step} i={i} req={r}"
            )
    same_state(*engines)


def test_keys_spread_across_shards(engines):
    t, j = engines
    hashes = slot_hash_batch([f"spread:{i}" for i in range(512)])
    owners = owner_of_np(hashes, t.n)
    counts = np.bincount(owners, minlength=8)
    assert (counts > 20).all(), counts  # roughly uniform ownership
    from gubernator_tpu.parallel.sharded import owner_of_np as j_owner_of_np

    np.testing.assert_array_equal(owners, j_owner_of_np(hashes, j.n))


def test_batch_is_sharded_not_replicated(engines):
    """Each shard's sub-batch holds only the rows it owns (~B/n), padded to
    the same rung and in the same layout as the JAX prep's."""
    t, j = engines
    B = 256
    hashes = slot_hash_batch([f"scale:{i}" for i in range(B)])
    args = (
        hashes, np.ones(B, np.int64), np.full(B, 10, np.int64),
        np.full(B, 1000, np.int64), np.zeros(B, np.int32), np.zeros(B, bool),
    )
    req, order, take_idx = pad_request_sharded(t.buckets, t.config.slots, t.n, *args)
    jreq, jorder, jtake = j_pad_request_sharded(j.buckets, j.config.slots, j.n, *args)
    for x, y in zip(req, jreq):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(take_idx, jtake)
    n_shards, B_sub = req.key_hash.shape
    assert n_shards == t.n
    counts = np.bincount(owner_of_np(hashes, t.n), minlength=8)
    assert B_sub == 64 and B_sub >= counts.max(), (B_sub, counts)
    for s in range(n_shards):
        v = req.valid[s]
        assert v.sum() == counts[s]
        assert (owner_of_np(req.key_hash[s][v], t.n) == s).all()
    back = np.empty(B, np.uint64)
    back[order] = req.key_hash.reshape(-1)[take_idx]
    assert (back == hashes).all()


def test_skewed_shard_overflows_ladder_gracefully(engines):
    """A batch past the ladder top, every key owned by shard 0, extends
    the rung progression and matches the oracle (and the JAX mesh); the
    paired GLOBAL calls accept the same oversized batch."""
    t, j = engines
    top = max(t.sub_buckets)
    n = top + 40
    pool = np.random.default_rng(3).integers(1, 1 << 63, size=16 * n, dtype=np.uint64)
    kh = pool[owner_of_np(pool, t.n) == 0][:n]
    assert kh.shape[0] == n
    cache = LRUCache()
    status, _, remaining, _ = decide_both(
        engines, T0, key_hash=kh, hits=np.ones(n, np.int64),
        limit=np.full(n, 10, np.int64), duration=np.full(n, 60_000, np.int64),
        algo=np.zeros(n, np.int32), gnp=np.zeros(n, bool),
    )
    want = get_rate_limit(
        cache, RateLimitReq(name="skew", unique_key="k", hits=1, limit=10, duration=60_000),
        now=T0,
    )
    assert (status == int(want.status)).all()
    assert (remaining == want.remaining).all()
    for e in engines:
        e.sync_globals(kh, np.full(n, 10, np.int64), np.full(n, 60_000, np.int64), now=T0)
        e.update_globals(
            kh, np.full(n, 10, np.int64), np.full(n, 9, np.int64),
            np.full(n, T0 + 60_000, np.int64), np.zeros(n, bool), now=T0,
        )
    same_state(*engines)


def _tags_and_remaining(store: np.ndarray):
    """tag and remaining lanes of a [n, buckets, ways*LANES] store."""
    from gubernator_tpu_torch.core.store import L_REMAINING, L_TAG

    ent = store.reshape(store.shape[0], store.shape[1], -1, LANES)
    return ent[..., L_TAG], ent[..., L_REMAINING]


def test_sync_globals_installs_replicas_on_all_shards(engines):
    t, j = engines
    reqs = [RateLimitReq(name="glob", unique_key="account:42", hits=1, limit=5,
                         duration=3 * SECOND)]
    a = arrays_for(reqs)
    decide_both(engines, T0, **a)  # two hits against the owner shard
    decide_both(engines, T0, **a)
    for e in engines:
        e.sync_globals(a["key_hash"], a["limit"], a["duration"], now=T0)
    same_state(*engines)
    fp = int((a["key_hash"][0] >> np.uint64(32)).astype(np.int64))
    fp = fp - (1 << 32) if fp >= 1 << 31 else fp
    tags, rem = _tags_and_remaining(t.store_numpy())
    assert (tags == fp).any(axis=(1, 2)).all()  # every shard holds it
    for s in range(t.n):
        assert (rem[s][tags[s] == fp] == 3).all(), s  # 5 - 2 hits


def test_sync_globals_leaky_preserves_owner_state(engines):
    reqs = [RateLimitReq(name="glk", unique_key="u", hits=5, limit=5, duration=5000,
                         algorithm=Algorithm.LEAKY_BUCKET)]
    a = arrays_for(reqs)
    decide_both(engines, T0, **a)  # drain to 0
    for e in engines:
        e.sync_globals(a["key_hash"], a["limit"], a["duration"], now=T0,
                       algo=np.full(1, 1, np.int32))
    status, _, remaining, _ = decide_both(engines, T0, **a)
    assert (int(status[0]), int(remaining[0])) == (int(Status.OVER_LIMIT), 0)
    same_state(*engines)


def test_mesh_grouped_subbatches_match_oracle(engines):
    """A duplicate-heavy batch whose sub-batches use a COMPACT group rung
    matches the oracle row for row, and the JAX mesh."""
    rng = random.Random(11)
    cache = LRUCache()
    keys = [f"grp:{i}" for i in range(120)]
    now = T0
    for step in range(3):
        now += 20
        reqs = [
            RateLimitReq(name="mesh-g", unique_key=rng.choice(keys), hits=1, limit=40,
                         duration=60_000)
            for _ in range(1600)
        ]
        status, limit, remaining, reset = decide_both(engines, now, **arrays_for(reqs))
        for i, r in enumerate(reqs):
            want = get_rate_limit(cache, r, now=now)
            assert (status[i], limit[i], remaining[i], reset[i]) == (
                int(want.status), want.limit, want.remaining, want.reset_time
            ), f"step={step} i={i}"
    same_state(*engines)


def test_mesh_duplicate_keys_one_batch(engines):
    reqs = [RateLimitReq(name="dup", unique_key="k", hits=1, limit=3, duration=SECOND)
            for _ in range(5)]
    status, _, remaining, _ = decide_both(engines, T0, **arrays_for(reqs))
    assert list(remaining) == [2, 1, 0, 0, 0]
    assert list(status) == [0, 0, 0, 1, 1]
    same_state(*engines)


def test_mesh_submit_wait_pipelined(engines):
    """Two batches in flight: submits ordered, each wait resolves its own
    batch, and batch 2 sees batch 1's charges."""
    t, j = engines
    reqs = [RateLimitReq(name="pipe", unique_key=f"k{i % 7}", hits=1, limit=4,
                         duration=60_000) for i in range(21)]
    a = arrays_for(reqs)
    out = []
    for e in engines:
        h1 = e.decide_submit(now=T0, **a)
        h2 = e.decide_submit(now=T0, **a)  # before h1's wait
        out.append((e.decide_wait(h1), e.decide_wait(h2)))
    (t1, t2), (j1, j2) = out
    same_out(t1, j1)
    same_out(t2, j2)
    s1, _, r1, _ = t1
    s2, _, r2, _ = t2
    for k in range(7):
        rows = [i for i in range(21) if i % 7 == k]
        assert [int(r1[i]) for i in rows] == [3, 2, 1]
        assert [int(s1[i]) for i in rows] == [0, 0, 0]
        assert [int(r2[i]) for i in rows] == [0, 0, 0]
        assert [int(s2[i]) for i in rows] == [0, 1, 1]
    same_state(*engines)


def test_mesh_wait_uses_submit_time_epoch(engines):
    """A rebase between submit and wait does not skew the in-flight
    batch's reset_time: the handle carries its submit-time epoch."""
    a = arrays_for([RateLimitReq(name="epoch", unique_key="x", hits=1, limit=5,
                                 duration=60_000)])
    resets = []
    for e in engines:
        h1 = e.decide_submit(now=T0, **a)
        h2 = e.decide_submit(now=T0 + REBASE_AT + 1000, **a)
        resets.append((int(e.decide_wait(h1)[3][0]), int(e.decide_wait(h2)[3][0])))
    assert resets[0] == resets[1]
    assert resets[0] == (T0 + 60_000, T0 + REBASE_AT + 1000 + 60_000)
    same_state(*engines)


# -- hierarchical ("host", "chip") mesh, BASELINE config 5 ---------------------


def test_hierarchical_mesh_matches_flat():
    """A 2-D ("host", "chip") mesh decides exactly as the flat 8-shard
    mesh (placement is the host-major flattened index; only the reduction
    is staged), and as the JAX package's 2-D mesh, through a sync."""
    cfg = StoreConfig(rows=4, slots=1 << 10)
    flat = MeshEngine(cfg, devices=CPU8, buckets=(64,))
    hier = MeshEngine(cfg, devices=CPU8, buckets=(64,), mesh_shape=(4, 2))
    jhier = JMeshEngine(JStoreConfig(rows=4, slots=1 << 10), buckets=(64,),
                        mesh_shape=(4, 2))
    assert hier.axes == ("host", "chip") == jhier.axes
    assert hier.policy.describe() == jhier.policy.describe()
    rng = random.Random(11)
    keys = [f"hier:{i}" for i in range(48)]
    now = T0
    for step in range(12):
        now += rng.choice([0, 5, 250])
        batch = rng.sample(keys, rng.randint(1, 32))
        a = dict(
            key_hash=slot_hash_batch(batch),
            hits=np.array([rng.randint(0, 3) for _ in batch], np.int64),
            limit=np.full(len(batch), 5, np.int64),
            duration=np.full(len(batch), 60_000, np.int64),
            algo=np.array([rng.randint(0, 1) for _ in batch], np.int32),
            gnp=np.zeros(len(batch), bool),
        )
        rf = flat.decide_arrays(now=now, **a)
        same_out(rf, hier.decide_arrays(now=now, **a), f"step {step}")
        same_out(rf, jhier.decide_arrays(now=now, **a), f"step {step} jax")
        if step == 6:
            for e in (flat, hier, jhier):
                e.sync_globals(a["key_hash"], a["limit"], a["duration"], now, a["algo"])
    np.testing.assert_array_equal(hier.store_numpy(), flat.store_numpy())
    np.testing.assert_array_equal(hier.store_numpy(), np.asarray(jhier.store.data))


def test_hierarchical_sync_stages_collectives(monkeypatch):
    """The port's staged sum runs the groups the JAX package's compiled
    sync step reduces over: on the 2-D mesh first the chips of each host
    ([[0,1],[2,3],[4,5],[6,7]], the ICI legs), then one partial a host
    across hosts ([[0,2,4,6],[1,3,5,7]]: chip c of every host), and on the
    flat mesh one sum over all 8."""
    import gubernator_tpu_torch.parallel.sharded as sh

    def sync_groups(eng):
        s = jax.ShapeDtypeStruct
        B = 64
        txt = eng._sync.lower(
            eng.store, s((B,), np.uint64), s((B,), np.int32), s((B,), np.int32),
            s((B,), np.int32), s((B,), np.int32), s((B,), bool), s((), np.int32),
        ).as_text()
        return {
            m.replace(" ", "")
            for m in re.findall(r'all_reduce"?[^\n]*?dense<(\[\[[^>]*\]\])>', txt)
        }

    def port_groups(policy):
        hosts = policy.host_groups()
        stages = {str([list(g) for g in hosts]).replace(" ", "")}
        if len(hosts) > 1:
            across = [[g[c] for g in hosts] for c in range(len(hosts[0]))]
            stages.add(str(across).replace(" ", ""))
        return stages

    jflat = JMeshEngine(JStoreConfig(rows=4, slots=256), buckets=(64,))
    jhier = JMeshEngine(JStoreConfig(rows=4, slots=256), buckets=(64,), mesh_shape=(4, 2))
    flat = MeshEngine(StoreConfig(rows=4, slots=256), devices=CPU8, buckets=(64,))
    hier = MeshEngine(StoreConfig(rows=4, slots=256), devices=CPU8, buckets=(64,),
                      mesh_shape=(4, 2))
    assert port_groups(flat.policy) == sync_groups(jflat) == {"[[0,1,2,3,4,5,6,7]]"}
    assert port_groups(hier.policy) == sync_groups(jhier)
    assert "[[0,1,2,3,4,5,6,7]]" not in port_groups(hier.policy)

    # and the sync really sums in those stages: count the adds per stage
    calls = []
    real = sh._hier_psum

    def spy(parts, policy, leader):
        calls.append(policy.host_groups())
        return real(parts, policy, leader)

    monkeypatch.setattr(sh, "_hier_psum", spy)
    kh = np.arange(1, 65, dtype=np.uint64) << np.uint64(32)
    ones = np.ones(64, np.int64)
    hier.sync_globals(kh, ones, ones * 1000, T0)
    assert calls and all(c == ((0, 1), (2, 3), (4, 5), (6, 7)) for c in calls)


def test_mesh_chained_batches_match_the_jax_mesh(engines):
    """Quota chains over 8 shards: each chain goes whole to its head's
    owner, and the no-partial-debit decide answers, charges and counts as
    the JAX mesh's over batches whose chains share ancestors and refuse at
    various levels."""
    t, j = engines
    rng = np.random.default_rng(9)
    tenants = slot_hash_batch([f"tenant:{i}" for i in range(6)])
    now = T0
    refused = 0
    for step in range(6):
        now += 50
        n_chains = int(rng.integers(4, 40))
        tenant = rng.integers(0, 6, n_chains)
        leaves = slot_hash_batch([f"leaf:{int(x)}" for x in rng.integers(0, 30, n_chains)])
        kh = np.stack([tenants[tenant], leaves], 1).reshape(-1)  # tenant, then leaf
        route = np.repeat(tenants[tenant], 2)  # the chain head: its tenant
        n = kh.shape[0]
        args = (
            kh, np.repeat(rng.integers(1, 3, n_chains), 2).astype(np.int64),
            np.tile(np.array([12, 4], np.int64), n_chains),
            np.full(n, 60_000, np.int64),
            np.tile(np.array([0, 2], np.int32), n_chains),
            np.repeat(np.arange(n_chains, dtype=np.int64), 2), route, now,
        )
        got = t.decide_chain_arrays(*args)
        same_out(got, j.decide_chain_arrays(*args), f"step {step}")
        refused += int((got[0] == 1).sum())
    assert refused > 0
    same_state(t, j)


@pytest.mark.parametrize("n, mesh_shape", [(2, None), (8, None), (8, (2, 4))],
                         ids=["2", "8", "2x4"])
def test_mesh_layouts_match_the_jax_mesh(n, mesh_shape):
    """One seeded stream through the port's mesh and the JAX package's at
    2 and 8 shards and on the 2-D (2, 4) mesh, the sketch tier on: all four
    algorithms with duplicate keys and clock steps, GLOBAL hit applies and
    syncs, replica installs, a chained batch, snapshot reads, sketch
    estimates and the full export, each identical, and the store and
    sketch bytes and stats after it."""
    from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
    from gubernator_tpu_torch.core.sketches import SketchConfig

    t = MeshEngine(StoreConfig(rows=4, slots=256), devices=["cpu"] * n, buckets=(64, 256),
                   mesh_shape=mesh_shape, sketch=SketchConfig(rows=2, width=1 << 10))
    j = JMeshEngine(JStoreConfig(rows=4, slots=256), devices=jax.devices()[:n],
                    buckets=(64, 256), mesh_shape=mesh_shape,
                    sketch=JSketchConfig(rows=2, width=1 << 10))
    assert t.policy.describe() == j.policy.describe()
    rng = np.random.default_rng(n + (7 if mesh_shape else 0))
    pool = rng.integers(1, 2**63, 700).astype(np.uint64)
    now = T0
    for step in range(10):
        now += int(rng.choice([0, 3, 500, 7000]))
        m = int(rng.integers(1, 300))
        f = dict(key_hash=pool[rng.integers(0, 700, m)],
                 hits=rng.integers(0, 4, m).astype(np.int64),
                 limit=rng.choice([2, 5, 50], m).astype(np.int64),
                 duration=rng.choice([1000, 60_000], m).astype(np.int64),
                 algo=rng.integers(0, 4, m).astype(np.int32), gnp=rng.random(m) < 0.1)
        same_out(t.decide_arrays(now=now, **f), j.decide_arrays(now=now, **f), f"step {step}")
        if step % 3 == 2:
            k = f["key_hash"][:40]
            args = (k, f["hits"][:40], f["limit"][:40], f["duration"][:40], now)
            same_out(t.apply_global_hits(*args, algo=f["algo"][:40]),
                     j.apply_global_hits(*args, algo=f["algo"][:40]), f"ghits {step}")
            for e in (t, j):
                e.sync_globals(k, f["limit"][:40], f["duration"][:40], now, f["algo"][:40])
                e.update_globals(pool[-30:], np.full(30, 9, np.int64), np.full(30, 4, np.int64),
                                 np.full(30, now + 9000, np.int64), np.arange(30) % 2 == 0,
                                 now=now)
    chain = (pool[:60], np.ones(60, np.int64), np.tile([30, 3], 30).astype(np.int64),
             np.full(60, 60_000, np.int64), np.zeros(60, np.int32),
             np.repeat(np.arange(30, dtype=np.int64), 2), np.repeat(pool[:60:2], 2), now + 1)
    same_out(t.decide_chain_arrays(*chain), j.decide_chain_arrays(*chain), "chained")
    assert t.snapshot_read(pool, now + 2) == j.snapshot_read(pool, now + 2)
    dur = np.full(700, 60_000, np.int64)
    np.testing.assert_array_equal(t.sketch_estimates(pool, dur, now + 2),
                                  j.sketch_estimates(pool, dur, now + 2))
    a, b = t.export_windows(now + 2), j.export_windows(now + 2)
    assert sorted(a) == sorted(b) and a["key_hash"].shape[0] > 100
    for col in a:
        np.testing.assert_array_equal(a[col], b[col], err_msg=col)
    same_state(t, j)
    np.testing.assert_array_equal(t.sketch_numpy(), np.asarray(j.sketch.data))
