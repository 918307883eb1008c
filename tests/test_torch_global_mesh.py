"""The port's mesh-native GLOBAL on the CPU: the cases of
tests/test_global_mesh_differential.py, with the JAX package's 8-device
mesh as a twin.

The one-step GLOBAL flush (MeshEngine.apply_global_hits: the owner charge,
the combine and the replica install) decides byte for byte as the RPC
gossip cycle it replaces, the owner's plain decide charge:

- the port's flat engine and its 8-shard mesh against the port's flat RPC
  reference, and the JAX package's 8-device mesh against both, over a
  seeded fuzz with interleaved decides and a final non-owner peek;
- through the serving stack: a ring with one off-mesh peer, the
  self-owned GLOBAL hits flushed through a port Instance over
  MeshBackend (apply_global_hits_reqs on the batcher's submit thread),
  the rest sent over RPC, and the state equal to a backend that received
  the same hits over the gossip door.
"""

import asyncio

import numpy as np

from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.parallel.sharded import MeshEngine as JMeshEngine
from gubernator_tpu_torch.api.types import Behavior, PeerInfo, RateLimitReq
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.parallel.sharded import MeshEngine, TorchEngine, owner_of_np
from gubernator_tpu_torch.serve.backends import MeshBackend, TorchBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance
from test_torch_replication import FakeClock, _pin_clock

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7976"
CPU8 = ["cpu"] * 8


def _arrays_equal(a, b, ctx=""):
    for name, x, y in zip(("status", "limit", "remaining", "reset"), a, b):
        np.testing.assert_array_equal(
            np.asarray(x, np.int64), np.asarray(y, np.int64), err_msg=f"{ctx}: {name}"
        )


def test_fuzz_collective_flush_equals_rpc_gossip_charge():
    """Mixed algorithms, limits, durations and clock jumps: every flush's
    post-charge answer and every interleaved decide is byte-identical
    between the RPC reference (a decide charge on a flat engine) and the
    one-step apply on the flat engine, the 8-shard mesh and the JAX
    package's 8-device mesh."""
    cfg = StoreConfig(rows=4, slots=1 << 10)
    rpc = TorchEngine(cfg, buckets=(64,), device="cpu")
    col_flat = TorchEngine(cfg, buckets=(64,), device="cpu")
    col_mesh = MeshEngine(cfg, devices=CPU8, buckets=(64,))
    j_mesh = JMeshEngine(JStoreConfig(rows=4, slots=1 << 10), buckets=(64,))
    cols = (("flat", col_flat), ("mesh", col_mesh), ("jax mesh", j_mesh))

    rng = np.random.default_rng(0x6E0B)
    n_keys = 48
    kh = rng.integers(1, 2**63, n_keys, np.int64).astype(np.uint64)
    assert len(set(owner_of_np(kh, col_mesh.n).tolist())) >= 4
    lim = rng.integers(3, 40, n_keys).astype(np.int64)
    dur = rng.integers(1, 60, n_keys).astype(np.int64) * 10_000
    algo = rng.integers(0, 2, n_keys).astype(np.int32)
    now = T0
    for rnd in range(8):
        now += int(rng.integers(0, 20_000))
        pick = np.flatnonzero(rng.random(n_keys) < 0.6)
        if pick.size == 0:
            continue
        hits = rng.integers(1, 5, pick.size).astype(np.int64)
        k, l, d, a = kh[pick], lim[pick], dur[pick], algo[pick]
        rr = rpc.decide_arrays(k, hits, l, d, a, np.zeros(pick.size, bool), now)
        for name, e in cols:
            _arrays_equal(rr, e.apply_global_hits(k, hits, l, d, now, algo=a),
                          f"round {rnd} {name}")
        if rnd % 3 == 2:
            now += 1
            one, gnp = np.ones(n_keys, np.int64), np.zeros(n_keys, bool)
            dr = rpc.decide_arrays(kh, one, lim, dur, algo, gnp, now)
            for name, e in cols:
                _arrays_equal(dr, e.decide_arrays(kh, one, lim, dur, algo, gnp, now),
                              f"round {rnd} {name} decide")
    now += 1
    zero, gnp = np.zeros(n_keys, np.int64), np.ones(n_keys, bool)
    pr = rpc.decide_arrays(kh, zero, lim, dur, algo, gnp, now)
    for name, e in cols:
        _arrays_equal(pr, e.decide_arrays(kh, zero, lim, dur, algo, gnp, now),
                      f"final {name} gnp peek")
    np.testing.assert_array_equal(col_mesh.store_numpy(), np.asarray(j_mesh.store.data))


def test_serve_level_mixed_ring_flush_equals_gossip_door(monkeypatch):
    """A ring with one off-mesh peer: self-owned GLOBAL hits flush through
    the real Instance's local apply (apply_global_hits_reqs on the mesh),
    off-mesh keys go over RPC to the fake peer, and the post-flush state
    equals a backend that received the self-owned hits over the gossip
    door (a decide)."""
    clock = FakeClock()
    _pin_clock(monkeypatch, clock)
    cfg = StoreConfig(rows=4, slots=1 << 10)
    ref = TorchBackend(cfg, buckets=(64,), device="cpu")
    backend = MeshBackend(cfg, devices=CPU8, buckets=(64,))
    assert backend.apply_global_hits_reqs is not None
    conf = ServerConfig(grpc_address=ADDR, advertise_address=ADDR, backend="mesh",
                        behaviors=BehaviorConfig(global_sync_wait=600.0), sketch=False)

    class OffMeshPeer:
        host = "10.9.9.9:7975"
        is_owner = False
        hit_batches: list = []

        async def get_peer_rate_limits(self, reqs):
            self.hit_batches.append(list(reqs))
            return []

        async def update_peer_globals(self, updates):
            pass

    off = OffMeshPeer()

    async def run():
        inst = Instance(conf, backend)
        inst.start()
        await inst.set_peers([PeerInfo(address=ADDR, is_owner=True)])
        self_peer = inst.get_peer("anything")
        assert self_peer.is_owner

        def route(key):
            return off if key.split("_", 1)[1].startswith("r") else self_peer

        monkeypatch.setattr(inst, "get_peer", route)
        try:
            mine = [RateLimitReq(name="gd", unique_key=f"m{i}", hits=(i % 3) + 1,
                                 limit=10, duration=60_000, behavior=Behavior.GLOBAL)
                    for i in range(24)]
            remote = [RateLimitReq(name="gd", unique_key=f"r{i}", hits=1, limit=10,
                                   duration=60_000, behavior=Behavior.GLOBAL)
                      for i in range(4)]
            for r in mine + remote:
                inst.global_mgr.queue_hit(r)
            await inst.global_mgr.drain()
            (sent,) = off.hit_batches
            assert {r.unique_key for r in sent} == {r.unique_key for r in remote}
            assert backend.engine.gossip_chunks == 1  # one in-mesh step
            ref.engine.get_rate_limits(mine, now=clock())
            clock.t += 5
            peek = [RateLimitReq(name="gd", unique_key=f"m{i}", hits=0, limit=10,
                                 duration=60_000) for i in range(24)]
            a = ref.engine.get_rate_limits(peek, now=clock())
            b = backend.decide(peek, [False] * len(peek), now=clock())
            for x, y in zip(a, b):
                assert (x.status, x.limit, x.remaining, x.reset_time) == (
                    y.status, y.limit, y.remaining, y.reset_time)
            await inst.apply_global_hits_local(mine[:2])
            assert set(inst.global_mgr._updates) == {r.hash_key() for r in mine[:2]}, (
                "local apply did not queue the owner broadcast")
        finally:
            await inst.stop()

    asyncio.run(asyncio.wait_for(run(), timeout=60))
