"""Hierarchical quota chains in the port against the JAX package, on the CPU.

The same inputs, made from numpy seeds or scripted, go through the JAX
package and the port; every answer must be identical (tolerance zero:
all of it is integer math):

- the kernel: `decide_presorted_chain` over random chains of depth 1-4
  (the leaf any of the four algorithms under TOKEN ancestors, ancestor
  keys shared across chains, refused chains rolled back), the store
  bytes, responses and stats after every batch, with the host group
  structure and without it; and the all-singleton identity: with every
  chain a singleton `decide_chain_arrays` equals `decide_arrays`
  (tests/test_chains.py::test_kernel_singleton_chain_identity);
- the engine: `TorchEngine.decide_chain_arrays` against the JAX flat
  engine's on the two-tier engine, whose sketch the chain decides leave
  byte for byte as it was;
- the backend: `TorchBackend.decide_chain` against `TpuBackend.decide_chain`
  on the scripted cases of tests/test_chains.py (no partial debit, the
  shallowest refusal wins, level-duration inheritance, duplicate level
  keys, shared ancestors under mixed leaf algorithms, plain traffic
  beside chains, the single-level identity) and a seeded stream, on both
  slot hashes (tests/test_torch_hash.py);
- the serving tier: the port's Instance, peer door and GEB frame core
  against the JAX package's on the serving cases of tests/test_chains.py
  (the chain lane and validation, the peer door, the kill switch with
  the hello's HELLO_CHAIN, the degraded fallback, the frame stage clock)
  and on a depth-3 chain through the Instance and the frame door, under
  one pinned clock.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.api.types as j_types
import gubernator_tpu.client_geb as j_client
import gubernator_tpu.core.engine as j_engine
import gubernator_tpu.serve.edge_bridge as j_bridge
import gubernator_tpu.serve.stages as j_stages
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.client_geb as t_client
import gubernator_tpu_torch.serve.edge_bridge as t_bridge
import gubernator_tpu_torch.serve.stages as t_stages
from test_torch_hash import HASHES, pin_hash
from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import store as jstore
from gubernator_tpu.core.engine import TpuEngine
from gubernator_tpu.core.sketches import SketchConfig as JSketchConfig
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.serve.backends import TpuBackend
from gubernator_tpu.serve.config import ServerConfig as JServerConfig
from gubernator_tpu.serve.instance import Instance as JInstance
from gubernator_tpu_torch.core import kernels as tk
from gubernator_tpu_torch.core import store as tstore
from gubernator_tpu_torch.core.engine import to_device
from gubernator_tpu_torch.core.sketches import SketchConfig
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.parallel.sharded import TorchEngine, pad_request_chained
from gubernator_tpu_torch.serve.backends import TorchBackend
from gubernator_tpu_torch.serve.config import ServerConfig
from gubernator_tpu_torch.serve.instance import Instance

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7977"  # the one node's ring address (never dialed)
B = 256
CPU = torch.device("cpu")


# -- the kernel ---------------------------------------------------------------


@jax.jit
def _jax_chain(data, req, now, groups, chain_id):
    store, resp, stats = jk.decide_presorted_chain(
        jstore.Store(data=data), req, now, chain_id, groups
    )
    return store.data, jk.pack_outputs(resp, stats)


@jax.jit
def _jax_chain_nogroups(data, req, now, chain_id):
    store, resp, stats = jk.decide_presorted_chain(jstore.Store(data=data), req, now, chain_id)
    return store.data, jk.pack_outputs(resp, stats)


def _chain_batch(rng, leaves: np.ndarray, ancestors: np.ndarray) -> dict:
    """Random chains of 1-4 levels (leaf included, at most B rows): the
    ancestors TOKEN counters drawn from a small shared pool (so chains
    share levels, and now and then one chain names a key twice), the
    leaf any algorithm, one hits value a chain; chain ids are sparse."""
    cols = {k: [] for k in ("key_hash", "hits", "limit", "duration", "algo", "chain", "route")}
    for c in range(int(rng.integers(1, B // 4 + 1))):
        depth = int(rng.integers(1, 5))
        keys = list(ancestors[rng.integers(0, ancestors.shape[0], depth - 1)])
        keys.append(leaves[min(int(rng.zipf(1.3)) - 1, leaves.shape[0] - 1)])
        hits = int(rng.choice([0, 1, 1, 2, 5]))
        for j, kh in enumerate(keys):
            leaf = j == depth - 1
            cols["key_hash"].append(kh)
            cols["hits"].append(hits)
            cols["limit"].append(int(rng.choice([2, 5, 20, 1000] if leaf else [3, 8, 30])))
            cols["duration"].append(int(rng.choice([400, 1000, 60_000] if leaf else [1000, 60_000])))
            cols["algo"].append(int(rng.integers(0, 4)) if leaf else 0)
            cols["chain"].append(7 * c + 3)
            cols["route"].append(keys[0])
    return dict(
        key_hash=np.asarray(cols["key_hash"], np.uint64),
        hits=np.asarray(cols["hits"], np.int64),
        limit=np.asarray(cols["limit"], np.int64),
        duration=np.asarray(cols["duration"], np.int64),
        algo=np.asarray(cols["algo"], np.int32),
        chain=np.asarray(cols["chain"], np.int64),
        route=np.asarray(cols["route"], np.uint64),
    )


@pytest.mark.parametrize(
    "seed, slots, rows, use_groups",
    [
        (1, 16, 4, True),  # 64 entries: drops and evictions
        (2, 16, 4, False),
        (3, 256, 16, True),  # roomy: long-lived level counters
    ],
)
def test_decide_presorted_chain_matches_jax(seed, slots, rows, use_groups):
    rng = np.random.default_rng(seed)
    leaves = rng.integers(1, 2**64, 300, dtype=np.uint64)
    ancestors = rng.integers(1, 2**64, 6, dtype=np.uint64)
    j_data = jnp.zeros((slots, rows * tstore.LANES), jnp.int32)
    t_store = tstore.new_store(tstore.StoreConfig(rows=rows, slots=slots), CPU)
    now = 1
    rolled_back = refused = algos = 0
    for step in range(30):
        now += int(rng.choice([0, 1, 3, 50, 400, 5000, 70_000]))
        f = _chain_batch(rng, leaves, ancestors)
        req, order, take, groups, chain_local = pad_request_chained(
            (B,), slots, 1, f["key_hash"], f["hits"], f["limit"], f["duration"],
            f["algo"], f["chain"], f["route"],
        )
        assert take is None and chain_local.dtype == np.int32
        cid_t = torch.from_numpy(chain_local)
        if use_groups:
            j_data, j_packed = _jax_chain(j_data, req, jnp.int32(now), groups, chain_local)
            _s, resp, stats = tk.decide_presorted_chain(
                t_store, to_device(req, CPU), now, cid_t, to_device(groups, CPU)
            )
        else:
            j_data, j_packed = _jax_chain_nogroups(j_data, req, jnp.int32(now), chain_local)
            _s, resp, stats = tk.decide_presorted_chain(t_store, to_device(req, CPU), now, cid_t)
        t_packed = tk.pack_outputs(resp, stats).numpy()
        np.testing.assert_array_equal(t_packed, np.asarray(j_packed), err_msg=f"step {step}")
        np.testing.assert_array_equal(
            t_store.data.numpy(), np.asarray(j_data), err_msg=f"store step {step}"
        )
        # what the stream covered: chains with a refused level and an
        # admitted hit-carrying one (rolled back), every leaf algorithm
        n = f["key_hash"].shape[0]
        status, cid = t_packed[:n], chain_local[:n]
        over = np.bincount(cid, weights=status == 1, minlength=B)
        admitted = np.bincount(cid, weights=(status == 0) & (req.hits[:n] > 0), minlength=B)
        rolled_back += int(((over > 0) & (admitted > 0)).sum())
        refused += int((over > 0).sum())
        algos |= int(np.bitwise_or.reduce(1 << f["algo"]))
    assert rolled_back > 0 and refused > rolled_back
    assert algos == 0b1111


def test_pad_request_chained_localizes_chain_slots():
    """Chain slots are dense in the sorted order, padding rows are
    singleton chains, and over shards (once refused) each chain lands
    whole on its head's owner with its slots localized per shard, the
    JAX package's layout array for array."""
    kh = np.array([9, 3, 9, 5, 3], np.uint64) << np.uint64(40)
    cols = [np.ones(5, np.int64), np.full(5, 10, np.int64), np.full(5, 1000, np.int64),
            np.zeros(5, np.int32)]
    chains = np.array([40, 7, 40, 7, 1000], np.int64)
    req, order, take, _groups, local = pad_request_chained(
        (8,), 16, 1, kh, *cols, chains, kh
    )
    assert take is None and local.shape == (8,)
    np.testing.assert_array_equal(np.unique(local[:5], return_inverse=True)[1],
                                  np.unique(chains[order], return_inverse=True)[1])
    assert local[:5].max() == 2
    np.testing.assert_array_equal(local[5:], np.arange(5, 8))
    from gubernator_tpu.parallel.sharded import pad_request_chained as j_pad_request_chained
    from gubernator_tpu_torch.parallel.sharded import owner_of_np

    # a chain's rows share its head's hash; heads on both shards
    cand = np.arange(1, 64, dtype=np.uint64) << np.uint64(40)
    h0, h1 = (cand[owner_of_np(cand, 2) == s][0] for s in (0, 1))
    route = np.array([h0, h1, h0, h1, h0], np.uint64)
    got = pad_request_chained((8,), 16, 2, kh, *cols, chains, route)
    want = j_pad_request_chained((8,), 16, 2, kh, *cols, chains, route)
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    sreq, sorder, stake, _g, slocal = got
    B_sub = sreq.key_hash.shape[1]
    assert sreq.key_hash.shape[0] == 2 and slocal.shape == sreq.key_hash.shape
    owner = owner_of_np(route, 2)
    assert sreq.valid.sum() == 5 and len(set(owner.tolist())) == 2
    # sorted row k (caller row sorder[k]) sits on shard stake[k] // B_sub:
    # every row with its chain head
    np.testing.assert_array_equal(owner[sorder], stake // B_sub)
    for s in range(2):
        v = sreq.valid[s]
        assert slocal[s][v].max() < v.sum()


def test_all_singleton_chains_equal_the_plain_decide():
    """With every chain a singleton, the chain decide's answers and store
    bytes are the plain decide's, in the port and in the JAX package,
    over mixed-algorithm batches with duplicate keys and clock advances."""
    rng = np.random.default_rng(5)
    cfg = StoreConfig(rows=16, slots=1 << 8)
    plain = TorchEngine(cfg, buckets=(64,), device="cpu")
    chained = TorchEngine(cfg, buckets=(64,), device="cpu")
    j_chained = TpuEngine(JStoreConfig(rows=16, slots=1 << 8), buckets=(64,))
    pool = rng.integers(1, 1 << 60, 24).astype(np.uint64)
    now = T0
    for step in range(30):
        now += int(rng.choice([0, 1, 40, 700]))
        n = int(rng.integers(1, 32))
        kh = pool[rng.integers(0, pool.shape[0], n)]
        hits = rng.choice([0, 1, 2, 9], n).astype(np.int64)
        limit = rng.choice([3, 8, 30], n).astype(np.int64)
        dur = rng.choice([400, 1000, 60_000], n).astype(np.int64)
        algo = rng.integers(0, 4, n).astype(np.int32)
        a = plain.decide_arrays(kh, hits, limit, dur, algo, np.zeros(n, bool), now)
        singles = np.arange(n, dtype=np.int64)
        b = chained.decide_chain_arrays(kh, hits, limit, dur, algo, singles, kh, now)
        c = j_chained.decide_chain_arrays(kh, hits, limit, dur, algo, singles, kh, now)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y, err_msg=f"step {step}")
            np.testing.assert_array_equal(y, np.asarray(z), err_msg=f"step {step}")
    np.testing.assert_array_equal(plain.store.data.numpy(), chained.store.data.numpy())
    np.testing.assert_array_equal(chained.store.data.numpy(), np.asarray(j_chained.store.data))


# -- the engine -----------------------------------------------------------------


def test_two_tier_engine_chains_match_jax_and_leave_the_sketch():
    """Chained batches on the two-tier engine decide exact-only: the
    answers and store bytes are the JAX engine's, and the sketch (filled
    first by plain traffic under tier pressure) keeps its bytes."""
    geo = (2, 1 << 12, 4)
    t = TorchEngine(StoreConfig(rows=1, slots=16), buckets=(64, 256), device="cpu",
                    sketch=SketchConfig(*geo))
    j = TpuEngine(JStoreConfig(rows=1, slots=16), buckets=(64, 256), sketch=JSketchConfig(*geo))
    rng = np.random.default_rng(9)
    pool = rng.integers(1, 2**64, 400, dtype=np.uint64)
    now = T0
    for step in range(6):  # plain traffic: creates the tier refuses reach the sketch
        n = 200
        args = (pool[rng.integers(0, pool.shape[0], n)], np.ones(n, np.int64),
                np.full(n, 5, np.int64), np.full(n, 60_000, np.int64),
                np.zeros(n, np.int32), np.zeros(n, bool), now + step)
        for x, y in zip(t.decide_arrays(*args), j.decide_arrays(*args)):
            np.testing.assert_array_equal(x, np.asarray(y))
    sk0 = t.sketch.data.clone()
    assert sk0.any() and t.stats.snapshot()["dropped"] > 0
    ancestors = rng.integers(1, 2**64, 6, dtype=np.uint64)
    for step in range(10):
        f = _chain_batch(rng, pool, ancestors)
        args = (f["key_hash"], f["hits"], f["limit"], f["duration"], f["algo"], f["chain"],
                f["route"], now + 10 + step * 300)
        for x, y in zip(t.decide_chain_arrays(*args), j.decide_chain_arrays(*args)):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"step {step}")
        np.testing.assert_array_equal(t.store.data.numpy(), np.asarray(j.store.data))
        assert torch.equal(t.sketch.data, sk0)
    np.testing.assert_array_equal(sk0.numpy(), np.asarray(j.sketch.data))
    assert t.stats.snapshot() == j.stats.snapshot()


# -- the backend ----------------------------------------------------------------

PKGS = {
    "torch": (t_types, lambda: TorchBackend(
        StoreConfig(rows=16, slots=1 << 10), buckets=(16, 64), device="cpu")),
    "jax": (j_types, lambda: TpuBackend(JStoreConfig(rows=16, slots=1 << 10), buckets=(16, 64))),
}


def _req(types, key, hits=1, limit=50, chain=(), algo=0, duration=60_000, behavior=0):
    return types.RateLimitReq(
        name="chain", unique_key=key, hits=hits, limit=limit, duration=duration,
        algorithm=types.Algorithm(algo), behavior=types.Behavior(behavior),
        chain=[types.ChainLevel(*lv) for lv in chain],
    )


def _t(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))


def _peek(be, types, key, limit=50, duration=60_000, now=None):
    """Plain read of a level counter."""
    return be.decide_wait(be.decide_submit(
        [_req(types, key, hits=0, limit=limit, duration=duration)], [False], now=now))[0]


def _depth3_no_partial_debit(mk, types):
    be, out = mk(), []
    chain = (("global", 100, 0), ("tenant", 2, 0))
    for i in range(5):
        rl = be.decide_chain([_req(types, "leaf", chain=chain)], now=T0 + i)[0]
        out.append(rl)
        if i < 2:
            assert rl.status == types.Status.UNDER_LIMIT, (i, rl)
        else:  # the tenant (limit 2) refuses: no debit at any level
            assert rl.status == types.Status.OVER_LIMIT and rl.limit == 2
            assert rl.metadata.get("chain_level") == "1"
    out.append(_peek(be, types, "global", limit=100, now=T0 + 9))
    assert out[-1].remaining == 98
    out.append(be.decide_chain([_req(types, "leaf", hits=0, chain=chain[:1])], now=T0 + 9)[0])
    assert out[-1].remaining == 48
    out.append(_peek(be, types, "tenant", limit=2, now=T0 + 9))
    assert out[-1].remaining == 0
    return out


def _shallowest_refusal_wins(mk, types):
    be = mk()
    chain = (("G", 1, 0), ("T", 1, 0))
    a = be.decide_chain([_req(types, "L", chain=chain)], now=T0)[0]
    b = be.decide_chain([_req(types, "L", chain=chain)], now=T0 + 1)[0]
    assert a.status == types.Status.UNDER_LIMIT
    assert b.status == types.Status.OVER_LIMIT and b.limit == 1
    assert b.metadata.get("chain_level") == "0"
    return [a, b]


def _level_duration_inheritance(mk, types):
    be = mk()
    rl = be.decide_chain([_req(types, "dl", duration=1000,
                               chain=(("dg", 5, 0), ("dt", 5, 30_000)))], now=T0)[0]
    out = [rl,
           _peek(be, types, "dg", limit=5, duration=1000, now=T0 + 1),
           _peek(be, types, "dg", limit=5, duration=1000, now=T0 + 1500),
           _peek(be, types, "dt", limit=5, duration=30_000, now=T0 + 1500)]
    assert [r.remaining for r in out[1:]] == [4, 5, 4]
    return out


def _duplicate_level_key(mk, types):
    be = mk()
    over = be.decide_chain([_req(types, "dup", hits=6, limit=10, chain=(("dup", 10, 0),))],
                           now=T0)[0]
    assert over.status == types.Status.OVER_LIMIT
    out = [over, _peek(be, types, "dup", limit=10, now=T0 + 1)]
    assert out[-1].remaining == 10  # the refused chain consumed nothing
    out.append(be.decide_chain([_req(types, "dup", hits=3, limit=10, chain=(("dup", 10, 0),))],
                               now=T0 + 2)[0])
    out.append(_peek(be, types, "dup", limit=10, now=T0 + 3))
    assert out[-2].status == types.Status.UNDER_LIMIT and out[-1].remaining == 4
    return out


def _shared_ancestor_mixed_leaves(mk, types):
    be, out = mk(), []
    for i, algo in enumerate((3, 0, 2, 3)):
        out.append(be.decide_chain([_req(types, f"ml{i}", chain=(("shared", 3, 0),), algo=algo,
                                         limit=10)], now=T0 + i)[0])
    assert [int(r.status) for r in out] == [0, 0, 0, 1]
    assert out[-1].metadata.get("chain_level") == "0"
    return out


def _chains_beside_plain_traffic(mk, types):
    be, out = mk(), []
    for algo in (3, 2):
        out.append(be.decide_chain([_req(types, f"cl-{algo}", chain=(("cg", 20, 0),), algo=algo,
                                         limit=10, duration=1000)], now=T0)[0])
    plain = [_req(types, f"p{a}", limit=5, duration=1000, algo=a) for a in range(4)]
    out += be.decide_wait(be.decide_submit(plain, [False] * 4, now=T0 + 1))
    assert all(r.status == types.Status.UNDER_LIMIT for r in out)
    assert [r.remaining for r in out[2:]] == [4] * 4
    return out


def _single_level_matches_plain(mk, types):
    chained, plain, out = mk(), mk(), []
    rng = np.random.default_rng(3)
    now = T0
    for _ in range(25):
        now += int(rng.choice([0, 1, 40, 700]))
        r = _req(types, f"sl{rng.integers(6)}", hits=int(rng.choice([0, 1, 2, 9])), limit=5,
                 algo=int(rng.integers(0, 4)), duration=2000)
        a = chained.decide_chain([r], now=now)[0]
        b = plain.decide_wait(plain.decide_submit([r], [False], now=now))[0]
        assert _t(a) == _t(b)
        out.append(a)
    return out


def _seeded_stream(mk, types):
    """Groups of chained requests of depth 0-3 over shared ancestors."""
    be, out = mk(), []
    rng = np.random.default_rng(17)
    now = T0
    for _ in range(12):
        now += int(rng.choice([0, 1, 300, 5000]))
        reqs = []
        for _ in range(int(rng.integers(1, 12))):
            t = int(rng.integers(0, 4))
            chain = [("g", 40, 0), (f"r{t % 2}", 15, int(rng.choice([0, 2000]))),
                     (f"t{t}", 4, 0)][: int(rng.integers(0, 4))]
            reqs.append(_req(types, f"k{t}:{rng.integers(8)}", hits=int(rng.choice([0, 1, 2])),
                             limit=int(rng.choice([3, 20])), chain=chain,
                             algo=int(rng.integers(0, 4)), duration=int(rng.choice([1000, 60_000]))))
        out += be.decide_chain(reqs, now=now)
    levels = {r.metadata.get("chain_level") for r in out if r.status == types.Status.OVER_LIMIT}
    assert {"0", "1", "2"} & levels and None in levels  # ancestors and leaves refuse
    return out


BACKEND_CASES = {f.__name__.strip("_"): f for f in (
    _depth3_no_partial_debit, _shallowest_refusal_wins, _level_duration_inheritance,
    _duplicate_level_key, _shared_ancestor_mixed_leaves, _chains_beside_plain_traffic,
    _single_level_matches_plain, _seeded_stream,
)}


@pytest.mark.parametrize("slot_hash", HASHES)
@pytest.mark.parametrize("case", sorted(BACKEND_CASES))
def test_backend_decide_chain_matches_jax(case, slot_hash, monkeypatch):
    pin_hash(monkeypatch, slot_hash)
    got = {name: [_t(r) for r in BACKEND_CASES[case](mk, types)]
           for name, (types, mk) in PKGS.items()}
    assert got["torch"] == got["jax"]


# -- the serving tier -----------------------------------------------------------

INSTANCES = {
    "torch": (t_types, ServerConfig, Instance, PKGS["torch"][1], t_bridge, t_client, t_stages),
    "jax": (j_types, JServerConfig, JInstance, PKGS["jax"][1], j_bridge, j_client, j_stages),
}


class FakeClock:
    def __init__(self):
        self.t = T0

    def __call__(self) -> int:
        return self.t


class FakePeer:
    host = "10.0.0.9:81"


@pytest.fixture
def clock(monkeypatch):
    """One pinned clock and one slot hash (blake2b-8) for both packages."""
    c = FakeClock()
    monkeypatch.setattr(j_types, "millisecond_now", c)
    monkeypatch.setattr(j_engine, "millisecond_now", c, raising=False)
    monkeypatch.setattr(t_types, "millisecond_now", c)
    pin_hash(monkeypatch, "blake2b")
    return c


def _serve(clock, case, **conf_kw):
    """Run the async `case(inst, pkg)` on a fresh one-node Instance of
    each package, from the same clock; returns {package: its result}."""
    out = {}
    for name, pkg in INSTANCES.items():
        types, conf_cls, inst_cls, mk = pkg[:4]

        async def run():
            inst = inst_cls(conf_cls(grpc_address=ADDR, advertise_address=ADDR, **conf_kw), mk())
            inst.start()
            await inst.set_peers([types.PeerInfo(address=ADDR, is_owner=True)])
            inst.shed.now_fn = clock
            try:
                return await case(inst, pkg)
            finally:
                await inst.stop()

        clock.t = T0
        out[name] = asyncio.run(run())
    return out


def test_instance_chain_lane_and_validation(clock):
    async def case(inst, pkg):
        types = pkg[0]
        chain = (("ig", 100, 0), ("it", 2, 0))
        r = await inst.get_rate_limits([_req(types, "il", chain=chain)] * 2)
        r += await inst.get_rate_limits([_req(types, "il", chain=chain)])
        deep = _req(types, "il", chain=[("a", 1, 0), ("b", 1, 0), ("c", 1, 0), ("d", 1, 0)])
        glob = _req(types, "il", chain=chain, behavior=int(types.Behavior.GLOBAL))
        r += await inst.get_rate_limits([deep, glob, _req(types, "il", chain=(("", 1, 0),))])
        return [_t(x) for x in r]

    got = _serve(clock, case)
    assert got["torch"] == got["jax"]
    r = got["torch"]
    assert [x[0] for x in r[:3]] == [0, 0, 1] and r[2][5] == {"chain_level": "1"}
    assert "GUBER_CHAIN_MAX_DEPTH" in r[3][4] and "GLOBAL" in r[4][4]
    assert "unique_key" in r[5][4]


def test_depth3_chain_through_the_instance_and_the_frame_door(clock):
    """The depth-3 no-partial-debit walk through Instance.get_rate_limits
    and through GEBC frames into the GEB frame core: answers and frame
    bytes identical."""

    async def case(inst, pkg):
        types, bridge, client = pkg[0], pkg[4], pkg[5]
        svc = bridge.FrameService(inst)
        chain = (("fg", 100, 0), ("fr", 50, 0), ("ft", 2, 0))
        out = []
        for i in range(4):
            clock.t += 1
            out.append([_t(x) for x in await inst.get_rate_limits(
                [_req(types, f"fl{i % 2}", chain=chain), _req(types, "plain")])])
        for i in range(3):
            frame, _fast = client.build_frame(
                [_req(types, "fl9", chain=chain[:1] + chain[2:]), _req(types, "plain")],
                fast=False, windowed=True, frame_id=20 + i)
            out.append(await svc.serve_frame_bytes(frame))
        return out

    got = _serve(clock, case)
    assert got["torch"] == got["jax"]
    status = [r[0][0] for r in got["torch"][:4]]
    assert status == [0, 0, 1, 1]  # the tenant (limit 2) refuses from the third
    assert got["torch"][3][0][5] == {"chain_level": "2"}


def test_peer_door_validates_chains(clock):
    async def case(inst, pkg):
        types = pkg[0]
        deep = _req(types, "pd", chain=[("a", 1, 0), ("b", 1, 0), ("c", 1, 0), ("d", 1, 0)])
        ok = _req(types, "pd", chain=(("pg", 5, 0),))
        return [_t(x) for x in await inst.get_peer_rate_limits([deep, ok, _req(types, "pp")])]

    got = _serve(clock, case)
    assert got["torch"] == got["jax"]
    rd, rok, plain = got["torch"]
    assert "GUBER_CHAIN_MAX_DEPTH" in rd[4]
    assert rok[0] == 0 and not rok[4] and plain[0] == 0 and not plain[4]
    off = _serve(clock, case, chains=False)
    assert off["torch"] == off["jax"]
    assert "GUBER_CHAINS" in off["torch"][1][4]


@pytest.mark.parametrize("chains", [True, False])
def test_kill_switch_and_the_hello_chain_bit(clock, chains):
    """GUBER_CHAINS=0 refuses chained items per item and leaves plain
    traffic alone; the frame doors' hello offers HELLO_CHAIN exactly
    while chains are served."""

    async def case(inst, pkg):
        types, bridge = pkg[0], pkg[4]
        r = await inst.get_rate_limits(
            [_req(types, "ks", chain=(("g", 5, 0),)), _req(types, "ks2")])
        return [_t(x) for x in r], bridge.FrameService(inst)._hello()

    got = _serve(clock, case, chains=chains)
    assert got["torch"] == got["jax"]
    (chained, plain), hello = got["torch"]
    assert plain[0] == 0 and not plain[4]
    assert ("GUBER_CHAINS" in chained[4]) == (not chains)
    assert t_client.parse_hello_bytes(hello).chain == chains


def test_fallbacks_never_decide_chains_as_plain(clock):
    """Degraded mode decides chained items on the local chain lane (every
    level, most restrictive wins), never as a leaf-only plain decide;
    plain items beside them take the plain lane."""

    async def case(inst, pkg):
        types = pkg[0]
        chained = _req(types, "fb", chain=(("fbt", 1, 0),))
        out = []
        for items in ([(0, chained)], [(0, chained), (1, _req(types, "fbp"))]):
            out.append([_t(x) for x in await inst._degraded_fallback(
                items, FakePeer(), RuntimeError("down"))])
        return out

    got = _serve(clock, case, degraded_local=True)
    assert got["torch"] == got["jax"]
    (d1,), (d2, p2) = got["torch"]
    assert d1[0] == 0 and d1[5]["degraded"] == "true"
    # the level (limit 1) is spent: refused at level 0, where a leaf-only
    # decide (limit 50) would have admitted it
    assert d2[0] == 1 and d2[5]["chain_level"] == "0"
    assert p2[0] == 0 and p2[5]["degraded"] == "true"


def _stage_counts(stages):
    """(frames, {stage: count}, coverage); the port's timeline stages
    (collect, submit_call, the dispatch and fetch children, promoter_tick,
    gc), which the JAX package does not record, are left out."""
    snap = stages.STAGES.snapshot()
    own = set(getattr(stages, "PER_TICK", ())) | (
        set(stages.PER_BATCH) - {"submit_host", "prep", "merge", "dispatch", "fetch_wait"})
    counts = {k: v["count"] for k, v in snap["stages"].items() if k not in own}
    return snap["frames"], counts, snap["coverage"]


def test_chain_lane_records_frame_stages(clock):
    """A GEBC chain frame records the per-frame stages (batch_queue,
    device, encode) and the per-batch submit_host the decide lanes
    record."""

    async def case(inst, pkg):
        types, bridge, client, stages = pkg[0], pkg[4], pkg[5], pkg[6]
        svc = bridge.FrameService(inst)
        stages.STAGES.reset()
        frame, is_fast = client.build_frame(
            [_req(types, "sc", chain=(("sg", 100, 0),))], fast=False, windowed=True, frame_id=7)
        assert not is_fast
        resp = await svc.serve_frame_bytes(frame)
        return resp, _stage_counts(stages)

    got = _serve(clock, case)
    (t_resp, (t_frames, t_counts, coverage)), (j_resp, (j_frames, j_counts, _)) = (
        got["torch"], got["jax"])
    assert t_resp == j_resp and t_frames == j_frames == 1
    assert t_counts == j_counts
    for stage in ("batch_queue", "device", "encode", "submit_host"):
        assert t_counts.get(stage, 0) >= 1, (stage, t_counts)
    assert coverage > 0.1  # the stages tile the frame (loose: sub-ms spans)


def test_chain_frame_flag_prefers_plain_lane_on_mixed_frames(clock):
    """One frame contributes one per-frame span: a frame with plain and
    chained items flags only the plain lane."""

    async def case(inst, pkg):
        types, stages = pkg[0], pkg[6]
        stages.STAGES.reset()
        r = await inst.get_rate_limits(
            [_req(types, "mx", chain=(("mg", 100, 0),)), _req(types, "plain-mx")],
            stage_frame=True)
        return [_t(x) for x in r], _stage_counts(stages)[1]

    got = _serve(clock, case)
    assert got["torch"] == got["jax"]
    counts = got["torch"][1]
    assert counts.get("device") == 1 and counts.get("batch_queue") == 1
