"""The port's key streams (cli/keystreams.py) against the JAX package's.

Both modules are numpy only, and every bench artifact's streams hang on
their constants, so the port's copy must be bit-identical: each constant
equal, and each function's output equal in dtype and bytes over fixed
seeds, sizes, phases and key spaces (tolerance zero).
"""

import numpy as np
import pytest

import gubernator_tpu.cli.keystreams as jk
import gubernator_tpu_torch.cli.keystreams as tk


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_constants_are_the_reference_recipe():
    for name in ("ZIPF_A", "MIX_MUL", "MIX_XOR", "STREAMS"):
        assert getattr(tk, name) == getattr(jk, name), name
    # the pinned values every committed BENCH artifact was drawn with
    assert (tk.ZIPF_A, tk.MIX_MUL, tk.MIX_XOR) == (
        1.2, 0x9E3779B97F4A7C15, 0xDEADBEEFCAFEF00D)


def test_every_public_function_is_ported():
    public = {n for n in dir(jk) if not n.startswith("_") and callable(getattr(jk, n))
              and getattr(getattr(jk, n), "__module__", "") == jk.__name__}
    assert public == {"hash_ids", "zipf_ids", "zipf_pool", "churn_pool",
                      "flash_crowd_pool", "tenant_zipf_ids", "stream_pool"}
    for n in public:
        assert callable(getattr(tk, n)), n


@pytest.mark.parametrize("seed", [0, 42, 2024])
def test_hash_ids(seed):
    ids = np.random.default_rng(seed).integers(0, 2**63, 4096, dtype=np.int64)
    ids[:3] = (0, 1, 2**63 - 1)
    _same(tk.hash_ids(ids), jk.hash_ids(ids))
    _same(tk.hash_ids(ids.astype(np.uint64)), jk.hash_ids(ids.astype(np.uint64)))


@pytest.mark.parametrize("key_space,size,seed", [
    (10_000_000, 50_000, 42), (100_000_000, (64, 128), 7), (1_000, 10_000, 3)])
def test_zipf_ids_and_pool(key_space, size, seed):
    _same(tk.zipf_ids(key_space, size, np.random.default_rng(seed)),
          jk.zipf_ids(key_space, size, np.random.default_rng(seed)))
    _same(tk.zipf_pool(key_space, size, np.random.default_rng(seed)),
          jk.zipf_pool(key_space, size, np.random.default_rng(seed)))
    # the default generator is the benches' pinned seed 42
    _same(tk.zipf_pool(key_space, size), jk.zipf_pool(key_space, size))


@pytest.mark.parametrize("key_space,size,phase", [
    (10_000_000, 4096, 0), (10_000_000, 4096, 9), (5_000, 4096, 3), (0, 64, 2)])
def test_churn_pool(key_space, size, phase):
    _same(tk.churn_pool(key_space, size, phase), jk.churn_pool(key_space, size, phase))


@pytest.mark.parametrize("phase,crowd,share", [(0, 64, 0.8), (5, 64, 0.8), (2, 7, 0.3)])
def test_flash_crowd_pool(phase, crowd, share):
    _same(tk.flash_crowd_pool(1 << 20, 8192, phase, crowd, share),
          jk.flash_crowd_pool(1 << 20, 8192, phase, crowd, share))
    _same(tk.flash_crowd_pool(1 << 20, 512, phase, rng=np.random.default_rng(11)),
          jk.flash_crowd_pool(1 << 20, 512, phase, rng=np.random.default_rng(11)))


@pytest.mark.parametrize("tenants,seed", [(64, 100), (64, 107), (5, 1)])
def test_tenant_zipf_ids(tenants, seed):
    _same(tk.tenant_zipf_ids(tenants, 256, np.random.default_rng(seed)),
          jk.tenant_zipf_ids(tenants, 256, np.random.default_rng(seed)))
    _same(tk.tenant_zipf_ids(tenants, 256), jk.tenant_zipf_ids(tenants, 256))


@pytest.mark.parametrize("name", ["zipf", "key-churn", "flash-crowd"])
@pytest.mark.parametrize("phase", [0, 4])
def test_stream_pool(name, phase):
    _same(tk.stream_pool(name, 1 << 24, 4096, np.random.default_rng(phase), phase),
          jk.stream_pool(name, 1 << 24, 4096, np.random.default_rng(phase), phase))


def test_unknown_stream_is_refused_alike():
    with pytest.raises(ValueError, match="unknown key stream") as t:
        tk.stream_pool("uniform", 10, 10)
    with pytest.raises(ValueError, match="unknown key stream") as j:
        jk.stream_pool("uniform", 10, 10)
    assert str(t.value) == str(j.value)
