"""The benchmark's YCSB key stream and the deployments drawn from it.

`portbench/streams/ycsb-zipfian.py` is held to YCSB's generator (Gray et
al.'s closed form, the FNV-1a fold) on fixed uniforms; the
`exact_zipf1b` configuration to the geometry the port derives from its
environment; and tiny twins of `exact_zipf1b.deep_ycsb` and
`two_tier_zipf100m.deep_ycsb`, built in a temporary copy of
`portbench/tests/tiny`, run whole on the CPU through the harness and its
comparison: sound runs correct, the `dedup` control not."""

from __future__ import annotations

import asyncio
import importlib.util
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PORTBENCH = REPO / "portbench"
ZETAN = 26.46902820178302


def _ycsb():
    spec = importlib.util.spec_from_file_location("ycsb_zipfian", PORTBENCH / "streams" / "ycsb-zipfian.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gray_rank(u: float, theta=0.99, items=10**10, zetan=ZETAN) -> int:
    """ZipfianGenerator.nextLong(items + 1) for one uniform, as YCSB
    writes it (ranks 0..items)."""
    n = items + 1
    eta = (1 - math.pow(2.0 / n, 1 - theta)) / (1 - (1 + math.pow(0.5, theta)) / zetan)
    uz = u * zetan
    if uz < 1.0:
        return 0
    if uz < 1.0 + math.pow(0.5, theta):
        return 1
    return int(n * math.pow(eta * u - eta + 1, 1.0 / (1.0 - theta)))


def _fnv_plain(v: int) -> int:
    """YCSB's Utils.fnvhash64, a byte at a time, with |h| of the signed
    hash (2^63 for -2^63)."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * 1099511628211) % (1 << 64)
    return (1 << 64) - h if h >= 1 << 63 else h


U_FIXED = [0.0, 1e-12, 0.0377, 0.03778, 0.0378, 0.0566, 0.0568, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99,
           0.999999, 1 - 2**-53]


def test_ranks_follow_grays_closed_form():
    """Rank by rank, on fixed uniforms across the three branches, the
    vectorised ranks are YCSB's scalar formula."""
    gen = _ycsb().Zipfian()
    got = gen.ranks(np.array(U_FIXED))
    assert got.tolist() == [_gray_rank(u) for u in U_FIXED]
    # YCSB's form reaches n = items + 1 itself where eta*u - eta + 1 rounds to 1
    assert got[0] == 0 and got[5] == 1 and got[-1] == 10**10 + 1


@pytest.mark.parametrize("rank,share", [(0, 1 / ZETAN), (1, 0.5**0.99 / ZETAN)])
def test_hottest_ranks_take_their_zipf_share(rank, share):
    """Rank 0 takes 1/zetan of the draws and rank 1 2^-0.99/zetan, within
    six standard errors."""
    n = 1 << 21
    r = _ycsb().Zipfian().ranks(np.random.default_rng(5).random(n))
    se = math.sqrt(share * (1 - share) / n)
    assert abs(np.mean(r == rank) - share) < 6 * se


@pytest.mark.parametrize("nbytes", [8, 5])
def test_fnvhash64_is_ycsbs_byte_loop(nbytes):
    """The vectorised hash equals the byte loop, also where the top bytes
    are known to be zero and their rounds are folded into one multiply."""
    m = _ycsb()
    v = np.random.default_rng(3).integers(0, 10**10 + 1, 4000)
    v[:4] = [0, 1, 255, 10**10]
    if nbytes == 8:
        v[4:6] = [2**62 + 12345, 2**63 - 1]
    got = m.fnvhash64(v, nbytes)
    assert got.dtype == np.uint64
    assert got.tolist() == [_fnv_plain(int(x)) for x in v]


@pytest.mark.parametrize("key_space", [1 << 14, 100_000_000, 1 << 30])
@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_ids_stay_in_the_key_space_and_repeat_for_a_seed(key_space, seed):
    m = _ycsb()
    a, b = m.Stream({"theta": 0.99}, key_space, seed), m.Stream({}, key_space, seed)
    x = a.ids(3, 1 << 16)
    assert x.dtype == np.int64 and x.min() >= 0 and x.max() < key_space
    assert np.array_equal(x, b.ids(3, 1 << 16))
    assert not np.array_equal(x, a.ids(4, 1 << 16))
    # the fold is the hash of the rank: rank 0's id is the hottest
    hot = int(_fnv_plain(0) % key_space)
    ids, counts = np.unique(x, return_counts=True)
    assert ids[np.argmax(counts)] == hot


def test_unscrambled_ids_are_the_ranks_folded():
    """`scrambled` false is YCSB's plain zipfian: the rank itself, folded
    into the key space, so id 0 is the hottest."""
    m = _ycsb()
    got = m.Stream({"scrambled": False}, 1 << 20, 7).ids(2, 1 << 12)
    want = m.Zipfian().ranks(np.random.default_rng([7, 2]).random(1 << 12)) % (1 << 20)
    assert np.array_equal(got, want) and np.bincount(got).argmax() == 0


def test_exact_zipf1b_is_the_geometry_its_environment_derives():
    """The configuration's env derives its stated store (2^27 buckets x 16
    ways, 64 GiB, no sketch) with a clean footprint lint, the store
    holds 2x the key space, and its cells and metric are in the
    benchmark."""
    from gubernator_tpu_torch.core.store import check_store_budget, store_capacity, store_footprint_bytes
    from gubernator_tpu_torch.serve.config import config_from_env

    cfg = json.loads((PORTBENCH / "configs" / "exact_zipf1b.json").read_text())
    conf = config_from_env(dict(cfg["env"]))
    store, geo = conf.store_config(), cfg["geometry"]
    assert conf.sketch_config() is None and geo["sketch_rows"] == 0
    assert (store.slots, store.rows) == (geo["buckets"], geo["ways"]) == (1 << 27, 16)
    assert store_footprint_bytes(store) == geo["bytes_on_card"] == 1 << 36
    assert store_capacity(store) == 2 * cfg["key_space"] == 1 << 31
    assert check_store_budget(store, conf.store_target_keys) == ""
    assert (cfg["assumed"]["limit"], cfg["assumed"]["duration_ms"]) == (60, 3_600_000)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    for cell, config in [("exact_zipf1b.deep_ycsb", "exact_zipf1b"),
                         ("two_tier_zipf100m.deep_ycsb", "two_tier_zipf100m")]:
        assert (cells[cell]["config"], cells[cell]["traffic"], cells[cell]["chips"]) == (config, "deep_ycsb", 1)
    assert [m for m in bench["per_layer"] if m["name"] == "create_share.deep"]


@pytest.mark.parametrize("stats,want", [(dict(misses=30, groups=120), 0.25), (dict(misses=0, groups=0), None)])
def test_create_share_reads_misses_over_groups(stats, want):
    spec = importlib.util.spec_from_file_location("create_share", PORTBENCH / "metrics" / "create_share.deep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(dict(window=dict(stats=stats))) == want


# -- tiny twins, run whole on the CPU ------------------------------------------

TINY_EXACT = {
    "source": "tiny twin of portbench/configs/exact_zipf1b.json",
    "env": {"GUBER_BACKEND": "tpu", "GUBER_SKETCH": "0", "GUBER_STORE_SLOTS": "1024",
            "GUBER_DEVICE_BATCH_LIMIT": "1024", "GUBER_DEVICE_DEEP_BATCH": "1",
            "GUBER_GRPC_ADDRESS": "127.0.0.1:9990"},
    "geometry": {"buckets": 1024, "ways": 16, "sketch_rows": 0, "sketch_width": 0},
    "key_space": 1 << 14,
    "prefill": None,
    "assumed": {"limit": 60, "duration_ms": 3_600_000, "hits": 1, "theta": 0.99},
    "guarantees": {"exact_tier": "exact per key while the entry is resident"},
    "reduced": [],
    "check": {"spans": [{"batches": 2}, {"batches": 2}], "min_batches": 4, "min_rows": 600,
              "start_buckets": 512, "start_counters": 0},
}
TINY_YCSB = {"loop": "closed", "callers": 4, "group_rows": 256, "stream": "ycsb-zipfian",
             "stream_params": {"theta": 0.99}, "algo_by_id_parity": [0, 0], "hits": 1,
             "warmup_s": 0.5, "trace_s": 0.5, "chunk_groups": 8}


@pytest.fixture
def ycsb_bench(tmp_path):
    """(BENCHMARK.json, folder) of portbench/tests/tiny plus the twins."""
    root = tmp_path / "bench"
    shutil.copytree(PORTBENCH / "tests" / "tiny", root)
    for sub in ("streams", "metrics"):
        shutil.copytree(PORTBENCH / sub, root / sub)
    (root / "configs" / "tiny_ycsb_exact.json").write_text(json.dumps(TINY_EXACT))
    (root / "traffic" / "deep_ycsb.json").write_text(json.dumps(TINY_YCSB))
    bench_file = root / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["configs"].append(dict(name="tiny_ycsb_exact", source="YCSB", file="configs/tiny_ycsb_exact.json",
                                 reduced=[], why="tiny twin of exact_zipf1b"))
    cells = [f"{config}.deep_ycsb" for config in ("tiny_ycsb_exact", "tiny_two")]
    for cell in cells:
        bench["workloads"].append(dict(name=cell, config=cell.split(".")[0], traffic="deep_ycsb",
                                       chips=1, why="tiny twin"))
    # the benchmark's per-layer metrics of the decide kernels, on the twins
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"] += [dict(m, workloads=cells) for m in real["per_layer"]
                           if m["name"] in ("rows_per_group.deep", "create_share.deep")]
    bench_file.write_text(json.dumps(bench))
    return bench_file, root


def _run(bench_file, root, workload, seed, trace=False, patch=None) -> dict:
    """One run of `workload` on the CPU through the harness and its
    comparison: run.py's main without its look for a card (this test
    process has JAX loaded, which the benchmark's own runs refuse)."""
    from portbench.harness import run_cell
    from portbench.run import result_of
    from portbench.spec import Spec

    spec = Spec(bench_file, root)
    w = spec.workload(workload)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    run = asyncio.run(run_cell(cfg, traffic, spec.stream(traffic["stream"]), seed, 1.0, trace, "cpu",
                               time.monotonic(), patch=patch))
    return result_of(run, spec, w, trace, 1)


@pytest.mark.parametrize("workload,control,correct", [
    ("tiny_ycsb_exact.deep_ycsb", None, True),
    ("tiny_ycsb_exact.deep_ycsb", "dedup", False),
    ("tiny_two.deep_ycsb", None, True),
])
def test_tiny_ycsb_cells(ycsb_bench, monkeypatch, workload, control, correct):
    """The twins of the two deep_ycsb cells are correct, and traced they
    report the create share and rows a group; under `dedup` (a key
    charged once a batch) the exact twin is not."""
    import gubernator_tpu_torch.core.kernels as kernels
    from portbench.control import Control

    monkeypatch.setattr(kernels, "_seg_scan", kernels._seg_scan)  # restored after a control
    out = _run(*ycsb_bench, workload, seed=2**31 + 29, trace=correct,
               patch=Control(control) if control else None)
    checks = out["checks"]
    assert out["correct"] is correct, checks
    assert out["failed"] == 0 and checks["answers_checked"]["value"] >= 600
    if correct:
        m = out["metrics"]
        assert 0 < m["create_share.deep"]["value"] <= 1 and m["rows_per_group.deep"]["value"] >= 1
    else:
        assert checks["answers_differing"]["value"] > 0
