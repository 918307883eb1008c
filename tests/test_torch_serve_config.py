"""The port's serving configuration, backend factory and metrics against
the JAX package's, on the CPU.

- `config_from_env` on a table of GUBER_* environments gives the same
  ServerConfig fields (bar the JAX-only `jax_platform`, and the three
  batcher knobs that the port resolves from the environment where the
  JAX package leaves them to its DeviceBatcher) and the same resolved
  `store_config()` / `sketch_config()` geometry, and refuses the same
  environments;
- `make_backend` builds the TorchBackend for GUBER_BACKEND=tpu on the
  device it is given, and refuses the backends not ported yet; an
  Instance refuses replication, rescale and checkpointing from the env;
- the port's metrics registry has the JAX registry's metric names, types,
  label sets and help texts, less those of features not ported yet, and
  renders the same exposition headers.
"""

import dataclasses

import pytest

from gubernator_tpu.serve import config as jconfig
from gubernator_tpu.serve import metrics as jmetrics
from gubernator_tpu_torch.serve import config as tconfig
from gubernator_tpu_torch.serve import metrics as tmetrics
from gubernator_tpu_torch.serve.backends import TorchBackend, make_backend
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


@pytest.mark.parametrize("backend", ["exact", "mesh", "multihost"])
def test_make_backend_refuses_backends_not_ported(backend):
    conf = tconfig.config_from_env({"GUBER_BACKEND": backend})
    with pytest.raises(ValueError, match=f"GUBER_BACKEND={backend} is not ported"):
        make_backend(conf, device="cpu")


@pytest.mark.parametrize(
    "env",
    [{"GUBER_REPLICATION": "1"}, {"GUBER_RESCALE": "1"},
     {"GUBER_CHECKPOINT_DIR": "/nonexistent/ckpt"},
     {"GUBER_CHECKPOINT_EXPORT_PEERS": "10.0.0.1:81"}],
    ids=["replication", "rescale", "checkpoint_dir", "checkpoint_export"],
)
def test_instance_refuses_managers_not_ported(env):
    conf = tconfig.config_from_env(dict(env, GUBER_STORE_SLOTS="16", GUBER_STORE_ROWS="1"))
    backend = make_backend(conf, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        Instance(conf, backend)


def _collectors(registry):
    return {
        (type(c).__name__, c._name, tuple(c._labelnames), c._documentation)
        for c in registry._collector_to_names
    }


#: metric families of what the port does not carry yet (the edge bridge,
#: the GEB door with its shm lane and frame gauges, replication, rescale,
#: checkpoint/restore): the port's registry leaves them out
UNPORTED_METRICS = (
    "edge_", "geb_", "frame_", "replication_", "replicated_", "rescale_",
    "checkpoint_", "restore_", "restored_",
)


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
