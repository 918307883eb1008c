"""What the comparison holds scales with the spans, not the state: the
recorder allocates no tensor as large as the store or the sketch, and the
start check finds a changed word of a sampled row, with and without a
sketch."""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from portbench import harness
from portbench.reference import prefill as ref_prefill
from portbench.reference.limiter import Geometry
from portbench.spec import Spec


class Allocations(TorchDispatchMode):
    """The most elements of any tensor an op makes, leaving out views of
    the state itself (the store and sketch tensors' own storage)."""

    def __init__(self, state):
        super().__init__()
        self.state = {t.untyped_storage().data_ptr() for t in state}
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in self.state:
                self.most = max(self.most, t.numel())
        return out


def _grown(bench_dir, name: str, mib: str, buckets: int, width: int) -> str:
    """A copy of tiny configuration `name` with a store of `mib` MiB, as a
    cell of its deep zipf traffic; returns the cell's name."""
    bench_file, root = bench_dir
    cfg = json.loads((root / "configs" / f"{name}.json").read_text())
    cfg["env"]["GUBER_STORE_MIB"] = mib
    cfg["geometry"].update(buckets=buckets, sketch_width=width)
    (root / "configs" / f"{name}_big.json").write_text(json.dumps(cfg))
    b = json.loads(bench_file.read_text())
    b["configs"].append(dict(name=f"{name}_big", source="test", file=f"configs/{name}_big.json", reduced=[],
                             why="a store larger than the spans' buffers"))
    traffic = "deep_zipf" if cfg["geometry"]["sketch_rows"] else "deep_zipf_mixed"
    cell = f"{name}_big.{traffic}"
    b["workloads"].append(dict(name=cell, config=f"{name}_big", traffic=traffic, chips=1, why="test"))
    bench_file.write_text(json.dumps(b))
    return cell


def _run(bench_dir, cell: str, seed: int, seconds: float = 1.0) -> dict:
    bench_file, root = bench_dir
    spec = Spec(bench_file, root)
    w = spec.workload(cell)
    traffic = spec.traffic(w["traffic"])
    return asyncio.run(harness.run_cell(spec.config(w["config"]), traffic, spec.stream(traffic["stream"]),
                                        seed, seconds, False, "cpu", time.monotonic()))


@pytest.mark.parametrize("name,mib,buckets,width", [("tiny_two", "32", 32768, 1 << 20),
                                                    ("tiny_exact", "32", 65536, 0)])
def test_the_recorder_allocates_nothing_the_size_of_the_state(bench_dir, monkeypatch, name, mib, buckets,
                                                              width):
    cell = _grown(bench_dir, name, mib, buckets, width)
    seen = []

    def watched(fn):
        def call(self, *a, **k):
            eng = self.eng if hasattr(self, "eng") else a[0].engine
            state = [eng.store.data] + ([eng.sketch.data] if eng.sketch is not None else [])
            with Allocations(state) as mode:
                out = fn(self, *a, **k)
            seen.append((fn.__name__, mode.most, [t.numel() for t in state]))
            return out
        return call

    for m in ("__init__", "_opening", "_gather", "_close", "host_spans"):
        monkeypatch.setattr(harness.Recorder, m, watched(getattr(harness.Recorder, m)))
    read = harness.read_start

    def read_start(eng, *a):
        state = [eng.store.data] + ([eng.sketch.data] if eng.sketch is not None else [])
        with Allocations(state) as mode:
            out = read(eng, *a)
        seen.append(("read_start", mode.most, [t.numel() for t in state]))
        return out

    monkeypatch.setattr(harness, "read_start", read_start)
    run = _run(bench_dir, cell, seed=2**31 + 5)
    names = {s[0] for s in seen}
    assert {"__init__", "_opening", "_gather", "_close", "host_spans", "read_start"} <= names
    smallest = min(seen[0][2])
    for fn, most, _ in seen:
        assert most < smallest, (fn, most, smallest)
    for sp in run["spans"]:
        for k, v in sp.items():
            if isinstance(v, np.ndarray):
                assert v.size < smallest, (k, v.size)
    from portbench.check import compare

    ok, checks = compare(run)
    assert ok, checks


def _changed_after_prefill(monkeypatch, bucket_at: int = 3):
    """Changes one word of a sampled bucket's row once the prefill is in,
    before the start is read."""
    read = harness.read_start

    def read_changed(eng, cfg, geo, seed, device, rec):
        first = read(eng, cfg, geo, seed, device, dict(rec))
        eng.store.data[int(first["buckets"][bucket_at]), 1] += 1
        return read(eng, cfg, geo, seed, device, rec)

    monkeypatch.setattr(harness, "read_start", read_changed)


def _with_prefill(bench_dir) -> str:
    """tiny_exact with a prefill of 20,000 sequential ids (no bucket
    overflows its 16 ways), as a cell."""
    bench_file, root = bench_dir
    cfg = json.loads((root / "configs" / "tiny_exact.json").read_text())
    cfg["prefill"] = dict(ids=20000, batch_rows=1024)
    (root / "configs" / "tiny_exact_pre.json").write_text(json.dumps(cfg))
    b = json.loads(bench_file.read_text())
    b["configs"].append(dict(name="tiny_exact_pre", source="test", file="configs/tiny_exact_pre.json",
                             reduced=[], why="an exact store with a prefill"))
    b["workloads"].append(dict(name="tiny_exact_pre.deep_zipf_mixed", config="tiny_exact_pre",
                               traffic="deep_zipf_mixed", chips=1, why="test"))
    bench_file.write_text(json.dumps(b))
    return "tiny_exact_pre.deep_zipf_mixed"


@pytest.mark.parametrize("sketch", [True, False])
def test_the_start_check_holds_a_prefill_and_sees_one_changed_word(bench_dir, run_cell, monkeypatch, sketch):
    cell = "tiny_two.deep_zipf" if sketch else _with_prefill(bench_dir)
    rc, out = run_cell(cell, seed=2**31 + 41, seconds=0.5)
    assert rc == 0 and out["correct"], out["checks"]
    assert out["checks"]["start_words_differing"]["value"] == 0
    _changed_after_prefill(monkeypatch)
    rc, out = run_cell(cell, seed=2**31 + 41, seconds=0.5)
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["start_words_differing"]["value"] > 0


def test_the_sampled_prefill_matches_the_whole_replay(monkeypatch):
    """Without a sketch the start check hashes the ids a block at a time and
    keeps the sampled buckets' keys; their rows are the whole replay's."""
    monkeypatch.setattr(ref_prefill, "HASH_BLOCK", 37)
    kh = np.arange(1, 3001, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    want = np.array([0, 5, 17, 40, 63])
    nows = np.arange(1, 31) * 100

    def kh_of(lo, hi):
        return kh[lo:hi]

    whole = Geometry(buckets=64, ways=4, sketch_rows=2, sketch_width=1024)
    exact = Geometry(buckets=64, ways=4)
    rows_w, _, coll_w = ref_prefill.prefill_state(kh_of, 3000, 100, nows, 1000, 60_000, whole, want)
    rows_e, sketch, coll_e = ref_prefill.prefill_state(kh_of, 3000, 100, nows, 1000, 60_000, exact, want)
    assert sketch is None and coll_w == coll_e
    assert (rows_e != 0).any() and np.array_equal(rows_w, rows_e)
