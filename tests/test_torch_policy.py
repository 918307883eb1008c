"""The port's sharding policy (parallel/policy.py) and shard ownership on
the CPU, against the JAX package's.

- ShardingPolicy's factories: the flat policy is the degenerate case, the
  mesh policy's axes, shard count, hierarchical flag and `describe()`
  equal the JAX policy's over as many devices (the 8 simulated devices of
  tests/conftest.py against the port's `["cpu"] * 8`), and a mesh_shape
  that does not tile the devices is refused.
- MeshEngine is TorchEngine under another policy: the shared surfaces are
  one implementation, not forks.
- owner_of (torch, int64 bit patterns, an unsigned 64-bit remainder built
  from 32-bit halves) equals owner_of_np and the JAX package's owner_of_np
  bit for bit, on hashes at and above 2^63 where a signed remainder would
  go wrong.
- The shard lists GUBER_BACKEND=mesh serves on: GUBER_SHARDS CPU shards
  on the CPU (1 at 0), and no GPU is the engine's own error.
"""

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu.parallel.policy import ShardingPolicy as JShardingPolicy
from gubernator_tpu.parallel.sharded import owner_of_np as j_owner_of_np
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.parallel.policy import ShardingPolicy, local_devices
from gubernator_tpu_torch.parallel.sharded import (
    MeshEngine,
    TorchEngine,
    owner_of,
    owner_of_np,
)
from gubernator_tpu_torch.serve.backends import mesh_devices

CPU8 = ["cpu"] * 8


def test_policy_factories_and_degenerate_shape():
    single = ShardingPolicy.single()
    jsingle = JShardingPolicy.single()
    assert single.flat and single.n_shards == 1 and single.devices is None
    assert single.describe() == jsingle.describe()
    assert "degenerate" in single.describe()

    mesh = ShardingPolicy.over_mesh(CPU8)
    jmesh = JShardingPolicy.over_mesh()
    assert not mesh.flat and mesh.n_shards == jmesh.n_shards == len(jax.devices()) == 8
    assert mesh.axes == jmesh.axes == ("shard",)
    assert not mesh.spans_processes and not mesh.hierarchical
    assert mesh.describe() == jmesh.describe()
    assert mesh.devices == (torch.device("cpu"),) * 8

    two_d = ShardingPolicy.over_mesh(CPU8, mesh_shape=(4, 2))
    jtwo_d = JShardingPolicy.over_mesh(mesh_shape=(4, 2))
    assert two_d.axes == jtwo_d.axes == ("host", "chip") and two_d.hierarchical
    assert two_d.describe() == jtwo_d.describe()
    assert two_d.host_groups() == ((0, 1), (2, 3), (4, 5), (6, 7))
    with pytest.raises(ValueError):
        ShardingPolicy.over_mesh(CPU8, mesh_shape=(3, 2))
    with pytest.raises(ValueError):
        JShardingPolicy.over_mesh(mesh_shape=(3, 2))
    with pytest.raises(ValueError, match="mesh policy"):
        MeshEngine(StoreConfig(rows=4, slots=256), policy=single)


def test_engine_classes_are_one_implementation():
    """MeshEngine is TorchEngine under a mesh policy: the surfaces whose
    work is layout-free (the request-object API, snapshot reads, installs,
    promotion, export and repartition, load_state) are the one
    implementation; the mesh overrides only the per-shard steps."""
    assert issubclass(MeshEngine, TorchEngine)
    flat = TorchEngine(StoreConfig(rows=4, slots=256), buckets=(64,), device="cpu")
    mesh = MeshEngine(StoreConfig(rows=4, slots=256), devices=CPU8, buckets=(64,))
    assert flat.policy.flat and flat.n == 1 and mesh.n == 8
    for name in (
        "get_rate_limits", "get_rate_limits_submit", "get_rate_limits_wait",
        "decide_arrays", "decide_chain_arrays", "snapshot_read", "live_mask",
        "install_windows", "update_globals", "sketch_estimates",
        "promote_from_sketch", "export_windows", "repartition", "load_state",
        "reset", "store_numpy", "_install_chunk", "_gather_entries", "_sketch_min",
    ):
        assert getattr(MeshEngine, name) is getattr(TorchEngine, name), name
    for name in ("_dispatch", "decide_submit", "decide_wait", "apply_global_hits",
                 "_device_shards", "_psum", "warmup"):
        assert getattr(MeshEngine, name) is not getattr(TorchEngine, name), name


def _high_hashes(n: int) -> np.ndarray:
    rng = np.random.default_rng(0x5EED)
    kh = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    kh[: n // 2] |= np.uint64(1 << 63)  # half at or above 2^63
    kh[:6] = [1 << 63, 2**64 - 1, (1 << 63) + 1, 0, 1, (1 << 63) - 1]
    return kh


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5, 7, 8, 16, 1000003])
def test_owner_of_matches_owner_of_np_above_2_63(n_shards):
    kh = _high_hashes(4096)
    want = owner_of_np(kh, n_shards)
    np.testing.assert_array_equal(want, j_owner_of_np(kh, n_shards))
    got = owner_of(torch.from_numpy(kh.view(np.int64)), n_shards)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() < n_shards


def test_mesh_devices_on_the_cpu_and_without_a_gpu(monkeypatch):
    assert local_devices("cpu") == (torch.device("cpu"),)
    assert mesh_devices(0, "cpu") == [torch.device("cpu")]
    assert mesh_devices(4, "cpu") == [torch.device("cpu")] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_devices(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardingPolicy.over_mesh()
