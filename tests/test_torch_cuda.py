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
from gubernator_tpu_torch.core.writeback import writeback_add, writeback_add_plain

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
