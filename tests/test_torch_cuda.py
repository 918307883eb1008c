"""The port on the card: tests that need an NVIDIA GPU.

Marked `cuda`; each decides inside the test whether a card is present
and skips with the reason where there is none (the CUDA kernel has no
CPU mode). This file imports neither jax nor gubernator_tpu, so it also
runs on a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance is zero throughout: the kernel and the decide are integer
math, and the card must reproduce the CPU bit for bit.
"""

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core.engine import TorchEngine
from gubernator_tpu_torch.core.sketches import derive_sketch_config
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.core.writeback import (
    ABLATION_ROWS,
    add_one,
    add_one_plain,
    writeback_add,
    writeback_add_plain,
    writeback_deltas,
    writeback_deltas_plain,
    writeback_full,
    writeback_rows,
    writeback_rows_plain,
)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the writeback kernel has no CPU mode")


def _recipe(seed: int, buckets: int, B: int, W: int):
    """Sorted buckets with long duplicate runs, way-disjoint delta rows,
    values over all of int32."""
    rng = np.random.default_rng(seed)
    ways = W // 8
    data = rng.integers(-(2**31), 2**31 - 1, (buckets, W), dtype=np.int64).astype(np.int32)
    bkt = np.sort(rng.integers(0, buckets, B)).astype(np.int32)
    lead = np.r_[True, bkt[1:] != bkt[:-1]]
    run = np.arange(B) - np.maximum.accumulate(np.where(lead, np.arange(B), 0))
    way = run % ways
    vals = rng.integers(-(2**31), 2**31 - 1, (B, 8), dtype=np.int64).astype(np.int32)
    vals[rng.random(B) < 0.3] = 0
    drow = np.zeros((B, ways, 8), np.int32)
    drow[np.arange(B), way] = vals
    return data, bkt, drow.reshape(B, W)


@pytest.mark.parametrize(
    "W, buckets, B", [(8, 64, 4096), (32, 512, 2048), (128, 4096, 32768), (128, 1 << 16, 300)]
)
def test_writeback_kernel_matches_plain(W, buckets, B):
    _need_card()
    data, bkt, drow = (torch.from_numpy(x).cuda() for x in _recipe(W + B, buckets, B, W))
    want = writeback_add_plain(data.clone(), bkt, drow)
    before = writeback_add.launches
    got = writeback_add(data, bkt, drow)
    torch.cuda.synchronize()
    assert writeback_add.launches == before + 1
    assert got.data_ptr() == data.data_ptr()
    assert torch.equal(got, want)


def test_native_hasher_builds_on_the_card_host():
    """The card's host builds and loads the native hasher and prep (g++
    at first use): the store hashes XXH64 and the prep is native, so the
    card tests below do not pass on the blake2b-8 fallback."""
    _need_card()
    from gubernator_tpu_torch.core.hashing import using_native_hash
    from gubernator_tpu_torch.native import load_hashlib

    assert load_hashlib() is not None and using_native_hash()


@pytest.mark.parametrize("krows", ABLATION_ROWS)
@pytest.mark.parametrize("W, buckets, B", [(128, 32768, 16384), (32, 512, 2048),
                                          (128, 1 << 16, 301)])
def test_ablation_kernels_match_plain(krows, W, buckets, B):
    """The writeback ablation's three steps (rows, deltas, full) at each
    chunk height, bit for bit against their plain versions, each launch
    counted once in its own counter (writeback_add's is the paths')."""
    _need_card()
    data, bkt, drow = (torch.from_numpy(x).cuda()
                       for x in _recipe(W + B + krows, buckets, B, W))
    counts = (writeback_full.launches, writeback_rows.launches,
              writeback_deltas.launches, writeback_add.launches)
    full = writeback_full(data.clone(), bkt, drow, krows)
    rows = writeback_rows(data.clone(), bkt, krows)
    deltas = writeback_deltas(torch.zeros_like(drow), bkt, drow, krows)
    torch.cuda.synchronize()
    assert (writeback_full.launches, writeback_rows.launches, writeback_deltas.launches,
            writeback_add.launches) == tuple(c + 1 for c in counts[:3]) + counts[3:]
    assert torch.equal(full, writeback_add_plain(data.clone(), bkt, drow))
    # each touched row plus one, once: a row skipped, doubled or misplaced shows
    want_rows = data.clone()
    want_rows[torch.unique(bkt).long()] += 1
    assert torch.equal(rows, writeback_rows_plain(data.clone(), bkt))
    assert torch.equal(rows, want_rows) and not torch.equal(rows, data)
    assert torch.equal(deltas, writeback_deltas_plain(torch.zeros_like(drow), bkt, drow, krows))


@pytest.mark.parametrize("n", [32768 * 128, 4096 * 128 + 3, 1])
def test_copy_floor_kernel_matches_plain(n):
    """The copy-floor kernel (x += 1) is bit-identical to x.add_(1),
    including the int32 wrap and a tail that is no whole vector."""
    _need_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(
        rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)).cuda()
    x[0] = 2**31 - 1
    want = add_one_plain(x.clone())
    before = add_one.launches
    got = add_one(x)
    torch.cuda.synchronize()
    assert add_one.launches == before + 1
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(got, want)
    assert int(got[0]) == -(2**31)


def test_engine_on_card_matches_cpu():
    _need_card()
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 2**64, 2000, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    gpu = TorchEngine(cfg, buckets=(256, 1024))
    cpu = TorchEngine(cfg, buckets=(256, 1024), device="cpu")
    now = 1_700_000_000_000
    before = writeback_add.launches
    for step in range(20):
        now += int(rng.choice([1, 50, 5000]))
        n = int(rng.integers(1, 1025))
        idx = np.minimum(rng.zipf(1.2, n) - 1, pool.shape[0] - 1)
        fields = (
            pool[idx], rng.choice([0, 1, 2], n), rng.choice([3, 100], n),
            rng.choice([1000, 60_000], n), rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )
        for a, b in zip(gpu.decide_arrays(*fields, now), cpu.decide_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert torch.equal(gpu.store.data.cpu(), cpu.store.data), f"step {step}"
    assert writeback_add.launches == before + 20
    assert gpu.stats.snapshot() == cpu.stats.snapshot()


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_two_tier_engine_on_card_matches_cpu(derivation):
    """The two-tier decide under tier pressure (a pool 4x the store, all
    four algorithms) and a promote: identical responses, store bytes and
    sketch counters on the card and on the CPU; every decide and every
    install chunk launches the writeback kernel once."""
    _need_card()
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    skc = derive_sketch_config(1, derivation=derivation)
    gpu = TorchEngine(cfg, buckets=(256, 1024), sketch=skc)
    cpu = TorchEngine(cfg, buckets=(256, 1024), device="cpu", sketch=skc)
    now = 1_700_000_000_000
    before = writeback_add.launches
    for step in range(16):
        now += int(rng.choice([1, 50, 5000]))
        n = int(rng.integers(1, 1025))
        idx = np.minimum(rng.zipf(1.1, n) - 1, pool.shape[0] - 1)
        fields = (
            pool[idx], rng.choice([0, 1, 2], n), rng.choice([3, 100], n),
            rng.choice([1000, 60_000], n), rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )
        for a, b in zip(gpu.decide_arrays(*fields, now), cpu.decide_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert torch.equal(gpu.store.data.cpu(), cpu.store.data), f"step {step}"
        assert torch.equal(gpu.sketch.data.cpu(), cpu.sketch.data), f"step {step}"
    assert gpu.stats.snapshot() == cpu.stats.snapshot()
    assert gpu.stats.snapshot()["dropped"] > 0
    keys = pool[:1500]  # 1500 > top rung 1024: two install chunks at most
    lim = np.full(keys.shape[0], 100)
    dur = np.full(keys.shape[0], 60_000)
    g = gpu.promote_from_sketch(keys, lim, dur, now + 1)
    c = cpu.promote_from_sketch(keys, lim, dur, now + 1)
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(gpu.store.data.cpu(), cpu.store.data)
    chunks = -(-int(g[0].sum()) // 1024)
    assert writeback_add.launches == before + 16 + chunks


def test_instance_on_card_matches_cpu(monkeypatch):
    """The serving core (Instance -> DeviceBatcher with arrival prep ->
    TorchBackend) on the card against the same stack on the CPU, one
    caller group at a time under one pinned clock, tier pressure on:
    identical responses, store and sketch bytes, stats, shed entries and
    one promoter tick's promotions."""
    _need_card()
    import asyncio

    import gubernator_tpu_torch.api.types as types
    import gubernator_tpu_torch.serve.promoter as promoter
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
    from gubernator_tpu_torch.serve.instance import Instance

    now = [1_700_000_000_000]
    monkeypatch.setattr(types, "millisecond_now", lambda: now[0])
    monkeypatch.setattr(promoter, "OBSERVE_MIN_INTERVAL_S", 0.0)
    addr = "127.0.0.1:7975"

    async def stack(device):
        conf = ServerConfig(
            grpc_address=addr, behaviors=BehaviorConfig(global_sync_wait=600.0),
            device_batch_limit=1024, sketch_sync_wait=600.0,
        )
        inst = Instance(conf, TorchBackend(
            StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024),
            sketch=SketchConfig(2, 1 << 12, 4), device=device,
        ))
        inst.start()
        await inst.set_peers([types.PeerInfo(address=addr, is_owner=True)])
        inst.shed.now_fn = lambda: now[0]
        return inst

    async def run():
        gpu, cpu = await stack(None), await stack("cpu")
        assert gpu.backend.device.type == "cuda"
        rng = np.random.default_rng(6)
        pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
        before, decides = writeback_add.launches, gpu.backend.stats()["batches"]
        for step in range(12):
            now[0] += int(rng.choice([1, 50, 5000]))
            n = int(rng.integers(1, 1000))
            f = dict(
                key_hash=pool[np.minimum(rng.zipf(1.1, n) - 1, pool.shape[0] - 1)],
                hits=rng.choice([0, 1, 2], n).astype(np.int64),
                limit=rng.choice([3, 100], n).astype(np.int64),
                duration=rng.choice([1000, 60_000], n).astype(np.int64),
                algo=rng.integers(0, 4, n).astype(np.int32),
            )
            a = await gpu.batcher.decide_arrays(dict(f))
            b = await cpu.batcher.decide_arrays(dict(f))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"step {step}")
            reqs = [types.RateLimitReq(name="s", unique_key=f"k{i % 40}", hits=1,
                                       limit=2, duration=60_000) for i in range(30)]
            ra = await gpu.get_rate_limits(reqs)
            rb = await cpu.get_rate_limits(reqs)
            assert [(r.status, r.remaining, r.reset_time) for r in ra] == [
                (r.status, r.remaining, r.reset_time) for r in rb]
        # one launch per device batch (shed-cache answers launch nothing)
        decides = gpu.backend.stats()["batches"] - decides
        assert decides >= 12 and writeback_add.launches == before + decides
        for inst in (gpu, cpu):
            await inst.promoter.flush_once()
        assert gpu.promoter.stats() == cpu.promoter.stats()
        assert gpu.backend.stats() == cpu.backend.stats()
        assert gpu.backend.stats()["dropped"] > 0
        assert dict(gpu.shed._entries) == dict(cpu.shed._entries)
        assert torch.equal(gpu.backend.engine.store.data.cpu(), cpu.backend.engine.store.data)
        assert torch.equal(gpu.backend.engine.sketch.data.cpu(), cpu.backend.engine.sketch.data)
        await gpu.stop()
        await cpu.stop()

    asyncio.run(run())


def test_decide_wait_does_not_wait_for_later_work():
    """decide_wait returns once its own batch's copy is done, while work
    queued after that batch still runs on the stream."""
    _need_card()
    eng = TorchEngine(StoreConfig(rows=16, slots=64), buckets=(256,))
    rng = np.random.default_rng(8)
    n = 200
    kh = rng.integers(0, 2**64, n, dtype=np.uint64)
    ones = np.ones(n, np.int64)
    h = eng.decide_submit(kh, ones, ones * 5, ones * 60_000, np.zeros(n, np.int32),
                          np.zeros(n, bool), 1_700_000_000_000)
    torch.cuda._sleep(2_000_000_000)  # ~1 s of later work on the same stream
    status, *_ = eng.decide_wait(h)
    assert not torch.cuda.current_stream().query(), "decide_wait waited for later work"
    assert (status == 0).all()
    torch.cuda.synchronize()


def test_device_topk_on_card_matches_cpu():
    """DeviceTopK on the card against the CPU: the same table after each
    fold and decay (ties, hashes >= 2^63, zero weights, B < K), and its
    read-back waits for the table's own stream only, not for the decide
    batches queued on the current stream."""
    _need_card()
    from gubernator_tpu_torch.serve.promoter import OBSERVE_TOP, DeviceTopK

    gpu, cpu = DeviceTopK(64), DeviceTopK(64, device="cpu")
    assert gpu._kh.device.type == "cuda"
    rng = np.random.default_rng(10)
    pool = rng.integers(1, 2**64, 300, dtype=np.uint64)
    for step in range(12):
        n = int(rng.integers(1, OBSERVE_TOP + 1))
        kh = np.unique(pool[rng.integers(0, pool.shape[0], n)])
        w = rng.choice([0, 1, 1, 3, 9], kh.shape[0]).astype(np.int64)
        pay = {int(k): (int(k % 7), 1000) for k in kh}
        for t in (gpu, cpu):
            t.observe_arrays(kh, w, pay)
        if step % 4 == 3:
            for t in (gpu, cpu):
                t.decay()
        assert gpu.top_with_payload(64) == cpu.top_with_payload(64), step
        assert torch.equal(gpu._kh.cpu(), cpu._kh) and torch.equal(gpu._cnt.cpu(), cpu._cnt)
    torch.cuda._sleep(2_000_000_000)  # ~1 s of decide-stream work
    gpu.observe_arrays(pool[:4], np.ones(4, np.int64), {})
    gpu.top_with_payload(8)
    assert not torch.cuda.current_stream().query(), "the top-K read waited for the stream"
    torch.cuda.synchronize()


def test_server_on_card_walks_a_key_through_grpc():
    """A one-node port Server (the doors) on the card: a limit-2 key
    walks 1 -> 0 -> OVER_LIMIT with one reset_time through gRPC, every
    answer decided by batches that launched the writeback kernel, and the
    launches equal to the decides plus the engine's chunks."""
    _need_card()
    import asyncio
    import socket

    from gubernator_tpu_torch.api.types import RateLimitReq, Status
    from gubernator_tpu_torch.client import AsyncV1Client
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    conf = config_from_env({"GUBER_GRPC_ADDRESS": addr, "GUBER_STORE_MIB": "64",
                            "GUBER_DEVICE_BATCH_LIMIT": "1024"})

    async def run():
        server = Server(conf)
        await server.start()
        client = AsyncV1Client(addr)
        try:
            assert server.backend.device.type == "cuda"
            assert (await client.health_check(timeout=10)).status == "healthy"
            eng = server.backend.engine
            before = writeback_add.launches
            counted = eng.stats.batches + eng.install_chunks + eng.gossip_chunks
            req = RateLimitReq(name="card", unique_key="walk", hits=1, limit=2,
                               duration=60_000)
            walk = [(await client.get_rate_limits([req], timeout=10))[0] for _ in range(3)]
            assert [r.remaining for r in walk] == [1, 0, 0]
            assert [r.status for r in walk] == [Status.UNDER_LIMIT, Status.UNDER_LIMIT,
                                                Status.OVER_LIMIT]
            assert len({r.reset_time for r in walk}) == 1 and not any(r.error for r in walk)
            if server.instance.promoter is not None:  # no tick between the reads
                await server.instance.promoter.stop()
            launched = writeback_add.launches - before
            counted = eng.stats.batches + eng.install_chunks + eng.gossip_chunks - counted
            assert launched >= 3 and launched == counted
        finally:
            await client.close()
            await server.stop()

    asyncio.run(run())
