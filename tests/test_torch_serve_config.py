"""The port's serving configuration, backend factory and metrics against
the JAX package's, on the CPU.

- `config_from_env` on a table of GUBER_* environments gives the same
  ServerConfig fields (bar the JAX-only `jax_platform`, and the three
  batcher knobs that the port resolves from the environment where the
  JAX package leaves them to its DeviceBatcher) and the same resolved
  `store_config()` / `sketch_config()` geometry, and refuses the same
  environments;
- `make_backend` builds the TorchBackend for GUBER_BACKEND=tpu on the
  device it is given, the host ExactBackend for GUBER_BACKEND=exact, the
  MeshBackend for mesh and the MultiHostBackend for multihost; an Instance
  builds the replication, rescale and checkpoint managers from the env;
- the port's metrics registry has the JAX registry's metric names, types,
  label sets and help texts, and renders the same exposition headers.
"""

import dataclasses

import jax
import pytest
import torch

from gubernator_tpu.serve import config as jconfig
from gubernator_tpu.serve import metrics as jmetrics
from gubernator_tpu_torch.serve import config as tconfig
from gubernator_tpu_torch.serve import metrics as tmetrics
from gubernator_tpu_torch.serve.backends import ExactBackend, TorchBackend, make_backend
from gubernator_tpu_torch.serve.instance import Instance

ENVS = [
    {},
    {"GUBER_STORE_MIB": "1024"},
    {"GUBER_STORE_MIB": "1024", "GUBER_SKETCH": "0"},
    {"GUBER_STORE_MIB": "64", "GUBER_SKETCH_MIB": "8", "GUBER_SKETCH_DERIVATION": "r13"},
    {"GUBER_STORE_MIB": "3"},
    {"GUBER_STORE_TARGET_KEYS": "100000"},
    {"GUBER_STORE_TARGET_KEYS": "100000", "GUBER_STORE_SLOTS": "4096"},
    {"GUBER_STORE_ROWS": "8", "GUBER_STORE_MIB": "256", "GUBER_SKETCH_ROWS": "3"},
    {"GUBER_SKETCH_MIB": "32", "GUBER_SKETCH_ROWS": "4"},
    {"GUBER_BACKEND": "exact", "GUBER_STORE_MIB": "64"},
    {
        "GUBER_BACKEND": "tpu", "GUBER_DEVICE_BATCH_LIMIT": "32768",
        "GUBER_DEVICE_DEEP_BATCH": "1", "GUBER_STORE_MIB": "1024",
        "GUBER_STORE_TARGET_KEYS": "100000000", "GUBER_SKETCH": "1",
        "GUBER_SKETCH_SYNC_WAIT_MS": "150", "GUBER_SHED_CACHE_KEYS": "1000",
    },
]

REFUSED = [
    {"GUBER_DEVICE_BATCH_LIMIT": "500"},
    {"GUBER_STORE_MIB": "64", "GUBER_STORE_SLOTS": "4096"},
    {"GUBER_LOG_LEVEL": "loud"},
    {"GUBER_SKETCH_DERIVATION": "v3"},
    {"GUBER_EDGE_TCP": "[::1]:9000"},
    {"GUBER_SHARDS": "2"},
]


#: resolved by the port's config_from_env; the JAX package leaves them
#: None/0 and reads the environment in its DeviceBatcher
BATCHER_KNOBS = ("prep_at_arrival", "prep_threads", "device_fetch_depth")


def _fields(conf) -> dict:
    d = dataclasses.asdict(conf)
    for k in ("jax_platform",) + BATCHER_KNOBS:
        d.pop(k, None)
    return d


def _geometry(store, sketch):
    return (
        (store.rows, store.slots),
        None if sketch is None else (sketch.rows, sketch.width, sketch.counter_bytes),
    )


@pytest.mark.parametrize("env", ENVS, ids=[str(i) for i in range(len(ENVS))])
def test_config_from_env_matches_jax(env):
    t = tconfig.config_from_env(dict(env))
    j = jconfig.config_from_env(dict(env))
    assert _fields(t) == _fields(j)
    assert _geometry(t.store_config(), t.sketch_config()) == _geometry(
        j.store_config(), j.sketch_config()
    )


@pytest.mark.parametrize(
    "env, want",
    [
        ({}, (True, 0, 2)),
        ({"GUBER_PREP_AT_ARRIVAL": "0", "GUBER_PREP_THREADS": "3",
          "GUBER_FETCH_DEPTH": "5"}, (False, 3, 5)),
        ({"GUBER_PREP_AT_ARRIVAL": "off"}, (False, 0, 2)),
    ],
    ids=["defaults", "set", "prep_off"],
)
def test_config_resolves_the_batcher_knobs(env, want, monkeypatch):
    """The batcher's knobs come from the config alone: config_from_env
    resolves them (the JAX defaults: prep at arrival, auto prep pool,
    fetch depth 2), and the Instance's DeviceBatcher takes them without
    reading the process environment."""
    conf = tconfig.config_from_env(dict(env, GUBER_STORE_SLOTS="16", GUBER_STORE_ROWS="1"))
    assert tuple(getattr(conf, k) for k in BATCHER_KNOBS) == want
    monkeypatch.setenv("GUBER_PREP_AT_ARRIVAL", "1" if not want[0] else "0")
    monkeypatch.setenv("GUBER_FETCH_DEPTH", "7")
    monkeypatch.setenv("GUBER_PREP_THREADS", "9")
    b = Instance(conf, make_backend(conf, device="cpu")).batcher
    assert (b.prep_at_arrival, b.fetch_depth) == (want[0], want[2])
    assert (b._prep_pool is not None) == want[0]
    assert b.prep_threads != 9
    if want[1]:
        assert b.prep_threads == want[1]


def test_config_strict_lint_and_carve_refusals_match_jax():
    for env in (
        {"GUBER_STORE_MIB": "16", "GUBER_SKETCH_MIB": "16"},
        {"GUBER_STORE_MIB": "1024", "GUBER_STORE_TARGET_KEYS": "100000",
         "GUBER_STORE_SIZE_STRICT": "1"},
    ):
        t = tconfig.config_from_env(dict(env))
        j = jconfig.config_from_env(dict(env))
        with pytest.raises(ValueError):
            j.store_config()
        with pytest.raises(ValueError):
            t.store_config()


@pytest.mark.parametrize("env", REFUSED, ids=[str(i) for i in range(len(REFUSED))])
def test_config_refusals_match_jax(env):
    with pytest.raises(ValueError):
        jconfig.config_from_env(dict(env))
    with pytest.raises(ValueError):
        tconfig.config_from_env(dict(env))


def test_config_file_loading(tmp_path):
    p = tmp_path / "guber.conf"
    p.write_text("# comment\nGUBER_STORE_MIB = 64\n\nGUBER_SKETCH=0\n")
    assert tconfig.load_config_file(str(p), {}) == jconfig.load_config_file(str(p), {})
    with pytest.raises(ValueError):
        p.write_text("no equals sign\n")
        tconfig.load_config_file(str(p), {})


def test_make_backend_builds_torch_backend_on_the_given_device():
    conf = tconfig.config_from_env(
        {"GUBER_STORE_MIB": "8", "GUBER_DEVICE_BATCH_LIMIT": "4096",
         "GUBER_DEVICE_DEEP_BATCH": "1"}
    )
    b = make_backend(conf, device="cpu")
    assert isinstance(b, TorchBackend)
    assert b.device.type == "cpu" and b.engine.device.type == "cpu"
    assert b.sketch_enabled
    assert b.engine.buckets == [64, 256, 1024, 4096]
    assert _geometry(b.engine.config, b.engine.sketch_config) == _geometry(
        conf.store_config(), conf.sketch_config()
    )


@pytest.mark.parametrize("backend", ["mesh", "multihost"])
def test_make_backend_builds_the_mesh_backends(backend):
    """mesh builds a MeshBackend on the CPU: GUBER_SHARDS shards of the one
    CPU (1 at 0), an explicit devices= list winning, with the JAX
    make_backend's geometry. multihost, with no process group joined,
    builds a MultiHostBackend whose engine is a one-process mesh over the
    local devices with no step pipe, as the JAX make_backend's is; its
    hello config is the JAX engine's but for the shard count (the JAX
    engine holds conftest's 8 simulated devices, the port the one CPU)."""
    from gubernator_tpu_torch.serve.backends import MeshBackend, MultiHostBackend

    if backend == "multihost":
        from gubernator_tpu.serve.server import make_backend as j_make_backend

        env = {"GUBER_BACKEND": "multihost", "GUBER_STORE_MIB": "8"}
        conf = tconfig.config_from_env(env)
        b = make_backend(conf, device="cpu")
        j = j_make_backend(jconfig.config_from_env(env))
        assert isinstance(b, MultiHostBackend) and type(j).__name__ == "MultiHostBackend"
        assert b.engine.pipe is None and j.engine.pipe is None
        assert b.engine.is_leader and j.engine.is_leader
        assert not b.engine.policy.spans_processes and b.engine.n == 1
        assert b.engine.devices == (torch.device("cpu"),)
        t_cfg, j_cfg = b.engine._config(), j.engine._config()
        assert t_cfg.pop("n_shards") == 1 and j_cfg.pop("n_shards") == len(jax.devices())
        assert t_cfg == j_cfg
        assert b.sketch_enabled and j.sketch_enabled
        two = make_backend(conf, device="cpu", devices=["cpu", "cpu"])
        assert isinstance(two, MultiHostBackend) and two.engine.n == 2
        return
    env = {"GUBER_BACKEND": "mesh", "GUBER_STORE_MIB": "8", "GUBER_SHARDS": "4"}
    conf = tconfig.config_from_env(env)
    b = make_backend(conf, device="cpu")
    assert isinstance(b, MeshBackend) and b.engine.n == 4
    assert b.engine.devices == (torch.device("cpu"),) * 4 and b.device.type == "cpu"
    assert b.sketch_enabled
    assert _geometry(b.engine.config, b.engine.sketch_config) == _geometry(
        conf.store_config(), conf.sketch_config()
    )
    one = make_backend(tconfig.config_from_env(dict(env, GUBER_SHARDS="0")), device="cpu")
    assert one.engine.n == 1
    two = make_backend(conf, device="cpu", devices=["cpu", "cpu"])
    assert two.engine.n == 2


def test_make_backend_builds_the_exact_backend():
    """GUBER_BACKEND=exact is the host LRU of GUBER_CACHE_SIZE entries, as
    the JAX make_backend builds it; it holds no device state."""
    from gubernator_tpu.serve.server import make_backend as j_make_backend

    env = {"GUBER_BACKEND": "exact", "GUBER_CACHE_SIZE": "321"}
    t = make_backend(tconfig.config_from_env(env))
    j = j_make_backend(jconfig.config_from_env(env))
    assert isinstance(t, ExactBackend) and not hasattr(t, "engine")
    assert (type(t).__name__, t.cache.max_size, t.inline_decide) == (
        type(j).__name__, j.cache.max_size, j.inline_decide)


@pytest.mark.parametrize(
    "env",
    [{"GUBER_REPLICATION": "1"}, {"GUBER_RESCALE": "1"},
     {"GUBER_CHECKPOINT_DIR": "/nonexistent/ckpt"},
     {"GUBER_CHECKPOINT_EXPORT_PEERS": "10.0.0.1:81"}],
    ids=["replication", "rescale", "checkpoint_dir", "checkpoint_export"],
)
def test_instance_builds_the_managers(env):
    """Each durability knob builds its manager with the knobs the JAX
    Instance reads (nothing is refused any more)."""
    conf = tconfig.config_from_env(dict(env, GUBER_STORE_SLOTS="16", GUBER_STORE_ROWS="1"))
    inst = Instance(conf, make_backend(conf, device="cpu"))
    built = {
        "repl": inst.repl is not None, "rescale": inst.rescale is not None,
        "checkpoint": inst.checkpoint is not None,
    }
    want = {
        "repl": conf.replication, "rescale": conf.rescale,
        "checkpoint": bool(conf.checkpoint_dir or conf.checkpoint_export_peers),
    }
    assert built == want and any(built.values())
    if inst.checkpoint is not None:
        assert inst.checkpoint.export_peers == conf.checkpoint_export_peers
        assert inst.checkpoint.dir == conf.checkpoint_dir


def _collectors(registry):
    return {
        (type(c).__name__, c._name, tuple(c._labelnames), c._documentation)
        for c in registry._collector_to_names
    }


#: metric families of what the port does not carry yet: the port's
#: registry leaves them out. Empty since the durability managers were
#: ported with their series
UNPORTED_METRICS = ()


def test_metrics_registry_matches_jax():
    t = _collectors(tmetrics.REGISTRY)
    j = _collectors(jmetrics.REGISTRY)
    assert not {c for c in t if c[1].startswith(UNPORTED_METRICS)}
    assert t == {c for c in j if not c[1].startswith(UNPORTED_METRICS)}
    assert len(t) > 30
    headers = lambda text: sorted(  # noqa: E731
        ln for ln in text.decode().splitlines()
        if ln.startswith("# ") and not ln.split()[2].startswith(UNPORTED_METRICS)
    )
    assert headers(tmetrics.render()) == headers(jmetrics.render())
