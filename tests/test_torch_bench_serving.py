"""The port's serving benchmarks (cli/bench_serving.py) against the JAX
package's, on the CPU.

- `measure_tail_error` (v2 with token, sliding and GCRA; r13 with token)
  and `measure_tail_error_ab` return dicts equal to the JAX package's on
  the same pinned stream (`batches=8`): the sketch is integer state, so
  the errors are the same numbers, not close ones. The JAX engines compile
  once for the module (the geometries repeat).
- `_filler_hashes` gives the same bytes.
- Each ported scenario runs at tiny flags with `--device cpu` and prints
  JSON with the JAX scenario's keys, row for row and nested dict for
  nested dict. The JAX rows come from the JAX scenario code run at the
  same flags, its stack's backend handed over to the port's CPU backend
  (so no XLA ladder compiles; the rows are built by the JAX code).
- The `shard` scenario (flat, 2 and 8 shards on the one CPU) prints the
  JAX scenario's keys, `--backend mesh` serves the reference suite, and
  `--device cuda` without a GPU fails with the engine's message.
"""

import contextlib
import dataclasses
import functools
import io
import json

import jax
import numpy as np
import pytest
import torch

import gubernator_tpu.cli.bench_serving as jb
import gubernator_tpu.serve.server as j_server
import gubernator_tpu_torch.cli.bench_serving as tb
import gubernator_tpu_torch.serve.backends as t_backends
import gubernator_tpu_torch.serve.config as t_config
from _util import free_ports

TAIL_BATCHES = 8
TAIL_CASES = {
    "v2_token": dict(),
    "v2_sliding": dict(algorithm="sliding"),
    "v2_gcra": dict(algorithm="gcra"),
    "r13_token": dict(derivation="r13"),
}


@pytest.fixture(scope="module")
def jax_tail():
    """The JAX package's tail-error dicts, computed once per module (the
    engine's jit compiles once a sketch geometry)."""
    cache = {}

    def get(case: str) -> dict:
        if case not in cache:
            if case == "ab":
                cache[case] = jb.measure_tail_error_ab(batches=TAIL_BATCHES)
            else:
                cache[case] = jb.measure_tail_error(batches=TAIL_BATCHES,
                                                    **TAIL_CASES[case])
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_measure_tail_error_equals_the_jax_dict(case, jax_tail):
    got = tb.measure_tail_error(batches=TAIL_BATCHES, device="cpu", **TAIL_CASES[case])
    assert got == jax_tail(case)
    assert got["under_counts"] == 0 and got["within_bound"]


def test_measure_tail_error_ab_equals_the_jax_dict(jax_tail):
    got = tb.measure_tail_error_ab(batches=TAIL_BATCHES, device="cpu")
    assert got == jax_tail("ab")
    assert got["zero_under_counts"] and got["v2_max_below_r13_bound"]


@pytest.mark.parametrize("slots", [64, 1024])
def test_filler_hashes_identical(slots):
    t, j = tb._filler_hashes(slots), jb._filler_hashes(slots)
    assert t.dtype == j.dtype == np.uint64
    assert t.tobytes() == j.tobytes()


# -- the scenarios --------------------------------------------------------------

#: per-scenario tiny flags (depth 1024 is the least rung the serving
#: tier's 1,000-item groups fit; the stores are a few MiB)
SCENARIOS = {
    "zipf10m": ["--scenario", "zipf10m", "--depths", "1024", "--keys", "2000",
                "--store-mib", "1", "--group", "256"],
    "zipf100m": ["--scenario", "zipf100m", "--depths", "1024", "--keys", "100000",
                 "--store-mib", "2", "--group", "256", "--rounds", "2"],
    "key-churn": ["--scenario", "key-churn", "--depths", "1024", "--keys", "5000",
                  "--store-mib", "2", "--group", "256"],
    "shed": ["--scenario", "shed", "--shed-shares", "0.0,0.9"],
    "flash-crowd": ["--scenario", "flash-crowd", "--depths", "1024", "--group", "256"],
    "mixed-tenant-zipf": ["--scenario", "mixed-tenant-zipf", "--depths", "1024"],
    "gcra-vs-token": ["--scenario", "gcra-vs-token", "--depths", "1024"],
}
SECONDS = ["--seconds", "0.3", "--json"]

#: dicts keyed by the run's data (which chain level refused), not a schema
DATA_KEYED = ("refusing_level",)


def _shape(obj):
    """The key structure of a JSON document: dicts by key, lists of dicts
    element by element, every other value as None."""
    if isinstance(obj, dict):
        return {k: (None if k in DATA_KEYED else _shape(v)) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_shape(x) for x in obj]
    return None


def _run(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _port_conf(conf):
    """The port's ServerConfig with every field of a JAX one."""
    return t_config.ServerConfig(**{f.name: getattr(conf, f.name)
                                    for f in dataclasses.fields(t_config.ServerConfig)})


@pytest.fixture
def jax_on_port_backend(monkeypatch):
    """Run the JAX scenario code with its stacks' backend built by the
    port on the CPU, and the tail-error rig at the module's batch count;
    the JAX compile-cache setting the shed scenario makes is restored."""
    monkeypatch.setattr(j_server, "make_backend",
                        lambda conf: t_backends.make_backend(_port_conf(conf), device="cpu"))
    monkeypatch.setattr(jb, "_jax_cache", lambda: None)
    for name in ("measure_tail_error", "measure_tail_error_ab"):
        monkeypatch.setattr(jb, name, functools.partial(getattr(jb, name),
                                                        batches=TAIL_BATCHES))
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_prints_the_jax_keys(scenario, jax_on_port_backend, jax_tail, monkeypatch):
    for name in ("measure_tail_error", "measure_tail_error_ab"):
        monkeypatch.setattr(tb, name, functools.partial(getattr(tb, name),
                                                        batches=TAIL_BATCHES))
    argv = SCENARIOS[scenario] + SECONDS
    rc, got, err = _run(tb.main, argv + ["--device", "cpu"])
    assert rc == 0, err[-3000:]
    rc, want, err = _run(jb.main, argv)
    assert rc == 0, err[-3000:]
    assert _shape(got) == _shape(want)
    for key in ("scope", "device"):
        if key in got:
            assert got[key] == "cpu"
    rows = got.get("rows", [])
    assert rows and all("error" not in r for r in rows)
    if scenario == "zipf100m":
        assert got["tail_error"]["batches"] == TAIL_BATCHES
        assert got["tail_error_derivation_ab"] == want["tail_error_derivation_ab"]
        assert got["tail_error_derivation_ab"] == jax_tail("ab")
        assert got["tail_error_arms"] == want["tail_error_arms"]


def _cluster_ports(monkeypatch, nodes: int) -> None:
    ports = free_ports(nodes + 3)
    monkeypatch.setattr(tb, "ADDRESSES", [f"127.0.0.1:{p}" for p in ports[:nodes]])
    monkeypatch.setattr(tb, "PYTHON_HTTP_ADDR", f"127.0.0.1:{ports[nodes]}")
    monkeypatch.setattr(tb, "EDGE_PORT", ports[nodes + 1])
    monkeypatch.setattr(tb, "EDGE_GRPC_PORT", ports[nodes + 2])


def test_cluster_suite_prints_the_jax_keys(monkeypatch):
    argv = ["--backend", "exact", "--nodes", "2"] + SECONDS
    _cluster_ports(monkeypatch, 2)
    rc, got, err = _run(tb.main, argv)
    assert rc == 0, err[-3000:]
    monkeypatch.setattr(jb, "ADDRESSES", tb.ADDRESSES)
    rc, want, err = _run(jb.main, argv)
    assert rc == 0, err[-3000:]
    assert _shape(got) == _shape(want)
    assert all(r["errors"] == 0 and r["ops"] > 0 for r in got["results"])


#: the rows of the reference suite with --edge, in its order
EDGE_ROWS = ["python_http_front_door", "edge_front_door", "global_1way_edge",
             "python_grpc_front_door", "edge_grpc_front_door",
             "edge_grpc_batched_concurrent", "no_batching", "get_rate_limit", "ping",
             "global", "thundering_herd", "batched", "batched_concurrent"]


def test_cluster_suite_on_the_cpu_device_backend_with_the_edge(monkeypatch):
    _cluster_ports(monkeypatch, 2)
    monkeypatch.setenv("GUBER_DEVICE_BATCH_LIMIT", "1024")
    rc, got, err = _run(tb.main, ["--backend", "tpu", "--device", "cpu", "--nodes", "2",
                                  "--edge"] + SECONDS)
    assert rc == 0, err[-3000:]
    assert [r["name"] for r in got["results"]] == EDGE_ROWS
    assert all(r["errors"] == 0 and r["ops"] > 0 for r in got["results"]), got["results"]
    assert (got["device"], got["n_devices"]) == ("cpu", 1)
    measured = {k for k in got["results"][0]}
    assert {"name", "ops", "errors", "seconds", "ops_per_sec", "workers"} <= measured
    assert "decisions_per_sec" in got["results"][EDGE_ROWS.index("edge_grpc_batched_concurrent")]


#: the JAX shard scenario's document keys (gubernator_tpu/cli/bench_serving.py
#: run_shard; its rungs spawn one process each, so it is not run here) and
#: the row keys it adds to _drive_pool's
SHARD_DOC_KEYS = {"scenario", "scope", "host_cpus", "shards_ladder", "served_via",
                  "env_knobs", "key_space", "notes", "rows"}
SHARD_ROW_KEYS = {"shards", "policy", "vs_flat", "decisions_per_sec", "mean_device_batch"}


@pytest.mark.parametrize("argv", [
    ["--scenario", "shard", "--shards", "2,8", "--shard-depth", "1024",
     "--shard-slots", "256", "--keys", "2000", "--group", "256"],
    ["--backend", "mesh", "--nodes", "2"],
], ids=["shard", "mesh"])
def test_multi_gpu_paths_are_refused(argv, monkeypatch):
    """Once refused, now served on the CPU: the shard ladder (a flat row,
    then 2 and 8 shards on the one CPU) with the JAX scenario's document
    and row keys, and the reference suite over --backend mesh nodes."""
    _cluster_ports(monkeypatch, 2)
    monkeypatch.setenv("GUBER_DEVICE_BATCH_LIMIT", "1024")
    rc, doc, err = _run(tb.main, argv + ["--device", "cpu"] + SECONDS)
    assert rc == 0, err[-3000:]
    if argv[1] == "shard":
        assert SHARD_DOC_KEYS <= set(doc) and doc["scope"] == "cpu"
        assert [(r["policy"], r["shards"]) for r in doc["rows"]] == [
            ("flat", 1), ("mesh", 2), ("mesh", 8)]
        assert all(SHARD_ROW_KEYS <= set(r) and r["decisions_per_sec"] > 0
                   for r in doc["rows"])
        assert doc["rows"][2]["shard_devices"] == ["cpu"] * 8
    else:
        assert all(r["errors"] == 0 and r["ops"] > 0 for r in doc["results"]), doc


def test_cuda_without_a_gpu_fails_with_the_engines_message(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(tb.main, SCENARIOS["gcra-vs-token"] + SECONDS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.measure_tail_error(batches=1)
