"""TorchEngine (the port's single-device engine) against the JAX
package's TpuEngine, and the port's import and device contracts.

The engine differential runs the same array stream through both
engines' decide_submit/decide_wait under fixed `now` values (duplicate
keys, all four algorithms, a clock jump that rebases the epoch), and
asserts identical responses, store bytes and stats after every batch
(tolerance zero: integer math). The host glue (presort, padding, group
rungs, clock) is compared on its own as well.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gubernator_tpu_torch as gt
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core import hashing as jhashing
from gubernator_tpu.core.engine import TpuEngine
from gubernator_tpu.core.store import StoreConfig as JConfig
from gubernator_tpu_torch.core import engine as tengine
from gubernator_tpu_torch.core import hashing as thashing
from gubernator_tpu_torch.core.engine import TorchEngine, buckets_for_limit
from gubernator_tpu_torch.core.store import StoreConfig, resolve_device

T0 = 1_700_000_000_000
LADDER = (64, 128)


def _stream(seed: int, steps: int):
    """(now, fields) batches: a hot key pool, mixed algorithms, and one
    forward jump past the engine's 2^30 ms epoch envelope."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64, 300, dtype=np.uint64)
    pool[:20] >>= np.uint64(32)
    now = T0
    for step in range(steps):
        now += int(rng.choice([0, 1, 7, 400, 5000, 61_000]))
        if step == steps // 2:
            now += (1 << 30) + 12_345  # rebase jump
        n = int(rng.integers(1, LADDER[-1] + 1))
        idx = np.minimum(rng.zipf(1.4, n) - 1, pool.shape[0] - 1)
        yield now, (
            pool[idx],
            rng.choice([0, 1, 1, 2, 5], n).astype(np.int64),
            rng.choice([1, 3, 10, 100], n).astype(np.int64),
            rng.choice([1000, 60_000, 3_600_000], n).astype(np.int64),
            rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )


def _assert_same(t_eng, j_eng, t_out, j_out, msg):
    for a, b, name in zip(t_out, j_out, ("status", "limit", "remaining", "reset")):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {msg}")
    np.testing.assert_array_equal(
        t_eng.store.data.numpy(), np.asarray(j_eng.store.data),
        err_msg=f"store {msg}",
    )
    assert t_eng.stats.snapshot() == j_eng.stats.snapshot(), msg
    assert t_eng.clock.epoch == j_eng.clock.epoch, msg


@pytest.mark.parametrize("seed, slots", [(1, 16), (2, 256)])
def test_engine_matches_tpu_engine(seed, slots):
    t = TorchEngine(StoreConfig(rows=16, slots=slots), buckets=LADDER, device="cpu")
    j = TpuEngine(JConfig(rows=16, slots=slots), buckets=LADDER)
    for step, (now, fields) in enumerate(_stream(seed, 24)):
        t_out = t.decide_wait(t.decide_submit(*fields, now))
        j_out = j.decide_wait(j.decide_submit(*fields, now))
        _assert_same(t, j, t_out, j_out, f"seed={seed} step={step}")
    assert t.stats.snapshot()["batches"] == 24


def test_load_state_carries_a_jax_store_mid_stream():
    t = TorchEngine(StoreConfig(rows=16, slots=64), buckets=LADDER, device="cpu")
    j = TpuEngine(JConfig(rows=16, slots=64), buckets=LADDER)
    for step, (now, fields) in enumerate(_stream(5, 16)):
        if step == 8:
            t.load_state(np.asarray(jax.device_get(j.store.data)), j.clock.epoch)
            t.stats = tengine.EngineStats()
            j.stats = jengine.EngineStats()
        j_out = j.decide_arrays(*fields, now)
        if step >= 8:
            t_out = t.decide_arrays(*fields, now)
            _assert_same(t, j, t_out, j_out, f"step={step}")
    with pytest.raises(ValueError):
        t.load_state(np.zeros((8, 128), np.int32), 0)


def test_host_glue_matches_jax():
    rng = np.random.default_rng(3)
    assert buckets_for_limit(32768) == jengine.buckets_for_limit(32768)
    assert buckets_for_limit(5000) == jengine.buckets_for_limit(5000)
    for b in (64, 1024, 32768, 131072):
        assert tengine.group_rungs(b) == jengine.group_rungs(b)
    for n in (1, 37, 64, 1000):
        kh = rng.integers(0, 2**64, n, dtype=np.uint64)
        kh[: n // 2] = kh[0]  # duplicates
        cols = (
            kh, rng.integers(-(2**40), 2**40, n), rng.integers(-5, 2**35, n),
            rng.integers(-(2**31), 2**31, n), rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.5,
        )
        t_req, t_order, t_groups = tengine.pad_request_sorted(
            (64, 1024), 512, *cols, with_groups=True
        )
        j_req, j_order, j_groups = jengine.pad_request_sorted(
            (64, 1024), 512, *cols, with_groups=True
        )
        np.testing.assert_array_equal(t_order, j_order)
        for a, b in zip(tuple(t_req) + tuple(t_groups), tuple(j_req) + tuple(j_groups)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    keys = [f"name_key:{i}" for i in range(50)]
    np.testing.assert_array_equal(
        thashing.slot_hash_batch(keys), jhashing._slot_hash_batch_py(keys)
    )
    assert thashing.ring_hash("a_b") == jhashing.ring_hash("a_b")


def test_get_rate_limits_walk():
    """A limit-2 token key walks remaining 1 -> 0 -> OVER_LIMIT with a
    stable reset time, through the request-object API."""
    e = TorchEngine(StoreConfig(rows=16, slots=16), buckets=(64,), device="cpu")
    e.warmup(now=T0)
    req = gt.RateLimitReq(name="n", unique_key="k", hits=1, limit=2, duration=60_000)
    out = [e.get_rate_limits([req], now=T0 + i)[0] for i in range(1, 4)]
    assert [r.remaining for r in out] == [1, 0, 0]
    assert [r.status for r in out] == [
        gt.Status.UNDER_LIMIT, gt.Status.UNDER_LIMIT, gt.Status.OVER_LIMIT
    ]
    assert len({r.reset_time for r in out}) == 1
    assert out[0].reset_time == T0 + 1 + 60_000
    assert e.stats.snapshot()["batches"] == 3  # warmup counters were wiped


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import gubernator_tpu_torch\n"
        "import numpy as np\n"
        "from gubernator_tpu_torch.core import (\n"
        "    algorithms, engine, kernels, sketches, store, writeback)\n"
        "from gubernator_tpu_torch.parallel.sharded import TorchEngine\n"
        "from gubernator_tpu_torch.serve import (\n"
        "    aio, backends, batcher, breaker, config, discovery, faults, global_mgr,\n"
        "    instance, logging_setup, metrics, peers, prep, promoter, server,\n"
        "    shedcache, stages, tracing)\n"
        "from gubernator_tpu_torch import client, cluster, endpoints\n"
        "from gubernator_tpu_torch.api import convert, grpc_glue\n"
        "from gubernator_tpu_torch.api.proto.gen import gubernator_pb2, peers_pb2\n"
        "from gubernator_tpu_torch.cli import cluster_main, daemon\n"
        "backends.make_backend(config.config_from_env({'GUBER_STORE_MIB': '8'}),"
        " device='cpu')\n"
        "e = TorchEngine(store.StoreConfig(rows=1, slots=16), buckets=(64,),"
        " device='cpu')\n"
        "e.get_rate_limits([gubernator_tpu_torch.RateLimitReq("
        "name='a', unique_key='b', hits=1, limit=1, duration=1000)])\n"
        "cfg, skc = sketches.derive_two_tier_config(4)\n"
        "s = TorchEngine(store.StoreConfig(rows=1, slots=16), buckets=(64,),"
        " device='cpu', sketch=sketches.SketchConfig(2, 1024, 4))\n"
        "kh = np.arange(1, 65, dtype=np.uint64) << np.uint64(32)\n"
        "one = np.ones(64, np.int64)\n"
        "s.decide_arrays(kh, one, one * 5, one * 1000, np.zeros(64, np.int32),"
        " np.zeros(64, bool), 1_700_000_000_000)\n"
        "assert s.stats.snapshot()['dropped'] > 0\n"
        "s.promote_from_sketch(kh, one * 5, one * 1000, 1_700_000_000_001)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'gubernator_tpu')"
        " or m.startswith(('jax.', 'jaxlib.', 'gubernator_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_no_gpu_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine(StoreConfig(rows=1, slots=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
