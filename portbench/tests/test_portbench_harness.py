"""Whole runs of tiny cells on the CPU: the comparison passes a sound
program, fails each planted fault and each control; the harness finds
files dropped into its folders; it refuses to time the CPU; and nothing it
loads is JAX or the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from portbench.control import Control
from portbench.devread import CHUNK
from portbench.reference.limiter import bucket_index

from conftest import PORTBENCH, REPO

CELLS = ["tiny_two.deep_zipf", "tiny_exact.deep_zipf_mixed", "tiny_two.deep_churn",
         "tiny_two.open_zipf_1000"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(run_cell, cell):
    rc, out = run_cell(cell, seed=2**31 + 17)
    assert rc == 0 and out["correct"], out and out["checks"]
    assert out["checks"]["answers_checked"]["value"] >= 600
    assert "setup_s" in out["metrics"] and out["failed"] == 0


def test_traced_run_reports_per_layer_metrics(run_cell):
    rc, out = run_cell("tiny_two.deep_zipf", seed=3, trace=1)
    assert rc == 0 and out["correct"]
    assert {"served_decisions_per_s.deep", "mean_device_batch.deep", "merge_ms.deep",
            "dispatch_ms.deep", "sketch_served_share.deep"} <= set(out["metrics"])
    assert "breakdown" in out and "window_s" in out["device"]
    assert list(out)[-1] == "checks"


class Fault:
    """A fault planted under the timed path (the harness's patch protocol)."""

    def __init__(self, kind):
        self.kind = kind
        self.planted = 0

    def before_boot(self):
        if self.kind == "state_unchanged":
            import gubernator_tpu_torch.core.kernels as kernels

            kernels._writeback_apply = lambda data, *a, **k: data

    def on_backend(self, backend):
        if self.kind in ("stray_row", "stray_counter"):
            # at each span's close, before its last reads: +1 to one word of
            # a bucket (or a sketch chunk) that no event of the span touched
            rec = backend.decide_submit_merged.__self__
            close = rec._close

            def stray_then_close(sp):
                self.stray(rec, sp)
                close(sp)

            rec._close = stray_then_close
        if self.kind == "stray_before_read":
            # +1 to a word of a bucket that the span's next event reads but
            # no earlier event of it touched, just before that event's
            # gather: the gather sees it, so only the digests can tell
            rec = backend.decide_submit_merged.__self__
            gather = rec._gather

            def stray_then_gather(sp, ev, kh, duration, victims):
                seen = np.concatenate([e["bk"] for e in sp.events] or [np.zeros(0, np.int64)])
                fresh = np.setdiff1d(bucket_index(kh, rec.geo.buckets), seen)
                if sp.events and fresh.shape[0]:
                    rec.eng.store.data[int(fresh[0]), 2] += 1
                    self.planted += 1
                return gather(sp, ev, kh, duration, victims)

            rec._gather = stray_then_gather
        if self.kind == "answer_altered":
            orig = backend.decide_wait_arrays

            def wait(handle):
                s, lim, rem, reset = orig(handle)
                rem = np.array(rem)
                rem[rem.shape[0] // 2] += 1
                return s, lim, rem, reset

            backend.decide_wait_arrays = wait
        if self.kind == "install_altered":
            orig_install = backend.engine.install_windows

            def install(kh, limit, remaining, *a, **k):
                return orig_install(kh, limit, np.asarray(remaining) + 1, *a, **k)

            backend.engine.install_windows = install
        if self.kind == "half_batch":
            orig = backend.engine.decide_submit_merged

            def submit(merged, now):
                n = merged["n"]
                req = merged["req"]
                valid = np.array(req.valid)
                valid[n // 2:n] = False
                return orig(dict(merged, req=req._replace(valid=valid)), now)

            backend.engine.decide_submit_merged = submit


    def stray(self, rec, sp):
        import torch

        if self.kind == "stray_row":
            touched = np.unique(np.concatenate([ev["bk"] for ev in sp.events] or [np.zeros(0, np.int64)]))
            free = np.setdiff1d(np.arange(rec.geo.buckets), touched)
            rec.eng.store.data[int(free[0]), 3] += 1
        else:
            touched = torch.unique(sp.bufs.ctr_idx[:sp.ctr_used] // CHUNK).numpy()
            free = np.setdiff1d(np.arange(rec.eng.sketch.data.numel() // CHUNK), touched)
            rec.eng.sketch.data.view(-1, CHUNK)[int(free[0]), 5] += 1
        self.planted += 1


def restore_kernels():
    import importlib

    import gubernator_tpu_torch.core.kernels as kernels

    importlib.reload(kernels)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["tiny_two.deep_zipf", "tiny_exact.deep_zipf_mixed"])
def test_planted_faults_are_not_correct(run_cell, cell, kind):
    try:
        rc, out = run_cell(cell, seed=11, patch=Fault(kind))
    finally:
        restore_kernels()
    assert rc == 0 and out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind,cell", [("stray_row", "tiny_two.deep_zipf"),
                                       ("stray_row", "tiny_exact.deep_zipf_mixed"),
                                       ("stray_counter", "tiny_two.deep_zipf"),
                                       ("stray_counter", "tiny_two.deep_churn"),
                                       ("stray_before_read", "tiny_exact.deep_zipf_mixed")])
def test_a_stray_write_outside_the_touched_state_is_not_correct(run_cell, kind, cell):
    """A word changed during a span in a row or chunk that no event of it
    had touched is seen by the digests alone: every answer and every
    touched word still match the reference's replay."""
    fault = Fault(kind)
    rc, out = run_cell(cell, seed=13, patch=fault)
    assert rc == 0 and out["correct"] is False and fault.planted > 0, out["checks"]
    assert out["checks"]["answers_differing"]["value"] == 0
    assert out["checks"]["state_words_differing"]["value"] >= CHUNK * fault.planted


def test_an_altered_promoter_install_is_not_correct(run_cell):
    """The promoter's installs inside a span are replayed too: one that
    installs a count one off is caught."""
    rc, out = run_cell("tiny_two.deep_churn", seed=11, seconds=2.0, patch=Fault("install_altered"))
    assert rc == 0 and out["correct"] is False, out["checks"]
    assert out["checks"]["installs_checked"]["value"] > 0
    assert out["checks"]["state_words_differing"]["value"] > 0


@pytest.mark.parametrize("control,cell", [("dedup", "tiny_exact.deep_zipf_mixed"),
                                          ("dedup", "tiny_two.deep_zipf"),
                                          ("undercount", "tiny_two.deep_zipf"),
                                          ("undercount", "tiny_two.deep_churn")])
def test_controls_are_not_correct(run_cell, control, cell):
    try:
        rc, out = run_cell(cell, seed=23, patch=Control(control))
    finally:
        restore_kernels()
    assert rc == 0 and out["correct"] is False, out["checks"]
    assert out["checks"]["answers_differing"]["value"] + out["checks"]["state_words_differing"]["value"] > 0


def test_dropped_files_make_a_new_cell(bench_dir, run_cell):
    """A configuration, a traffic mix, a key stream and a metric added as
    files only, and named in BENCHMARK.json, run as a cell."""
    bench_file, root = bench_dir
    cfg = json.loads((root / "configs" / "tiny_exact.json").read_text())
    cfg["assumed"]["limit"] = 50
    (root / "configs" / "tiny_exact_l50.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "deep_zipf.json").read_text())
    tr.update(stream="hot-pair", stream_params={})
    (root / "traffic" / "hot_pair.json").write_text(json.dumps(tr))
    (root / "streams" / "hot-pair.py").write_text(textwrap.dedent('''
        import numpy as np

        class Stream:
            def __init__(self, params, key_space, seed, start=0):
                pass

            def ids(self, k, rows):
                return np.arange(rows, dtype=np.int64) % 2
    '''))
    (root / "metrics" / "groups_sent.hot.py").write_text(textwrap.dedent('''
        def read(run):
            return run["window"]["sent"]
    '''))
    b = json.loads(bench_file.read_text())
    b["configs"].append(dict(b["configs"][1], name="tiny_exact_l50", file="configs/tiny_exact_l50.json"))
    b["workloads"].append(dict(name="tiny_exact_l50.hot_pair", config="tiny_exact_l50", traffic="hot_pair",
                               chips=1, why="two keys only"))
    b["end_to_end"][0]["workloads"].append("tiny_exact_l50.hot_pair")
    b["per_layer"].append(dict(name="groups_sent.hot", unit="groups", better="higher",
                               source="host_clock", layer="load generator", moves="device_us_per_kdec",
                               workloads=["tiny_exact_l50.hot_pair"]))
    bench_file.write_text(json.dumps(b))
    rc, out = run_cell("tiny_exact_l50.hot_pair", seed=5)
    assert rc == 0 and out["correct"], out["checks"]
    # device_us_per_kdec times replays by CUDA events: on the CPU it finds nothing
    assert set(out["metrics"]) == {"setup_s"}
    rc, out = run_cell("tiny_exact_l50.hot_pair", seed=6, trace=1)
    assert rc == 0 and out["metrics"]["groups_sent.hot"]["value"] > 0


def test_no_card_exits_without_a_result(bench_dir, capsys):
    """Where there is no card, the measurement path fails rather than
    timing the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from portbench import run

    bench_file, root = bench_dir
    rc = run.main(["--workload", "tiny_two.deep_zipf", "--seed", "1", "--seconds", "1"],
                  bench_file=bench_file, root=root)
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == "" and "CUDA" in cap.err


def test_without_the_program_it_exits_nonzero(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    fails: there is no program to measure."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PORTBENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "two_tier_zipf100m.deep_zipf",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


FORBIDDEN = {"jax", "jaxlib", "flax", "gubernator_tpu"}


def test_a_run_loads_no_jax_and_the_reference_loads_no_program(tmp_path):
    """A whole tiny run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax or gubernator_tpu (compared whole, so the
    port's gubernator_tpu_torch passes); the reference loads nothing of
    the port."""
    code = textwrap.dedent(f'''
        import json, sys, time
        sys.path.insert(0, {str(REPO)!r})
        sys.path.insert(0, {str(PORTBENCH / "tests")!r})
        import portbench.reference.limiter, portbench.reference.prefill, portbench.check
        ref = sorted({{m.split(".")[0] for m in sys.modules}})
        from portbench import run
        run.T_START = time.monotonic()
        rc = run.main(["--workload", "tiny_exact.deep_zipf_mixed", "--seed", "3", "--seconds", "0.5"],
                      device="cpu", bench_file={str(PORTBENCH / "tests" / "tiny" / "BENCHMARK.json")!r},
                      root=sys.argv[1])
        top = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps(dict(rc=rc, ref=ref, top=top)))
    ''')
    root = tmp_path / "root"
    shutil.copytree(PORTBENCH / "tests" / "tiny", root)
    for sub in ("streams", "metrics"):
        shutil.copytree(PORTBENCH / sub, root / sub)
    r = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True, cwd=REPO)
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "gubernator_tpu_torch" in got["top"] and not FORBIDDEN & set(got["top"])
    assert not {"gubernator_tpu_torch", "torch"} & set(got["ref"]) and not FORBIDDEN & set(got["ref"])


def test_run_refuses_a_process_that_loaded_jax(run_cell, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out = run_cell("tiny_exact.deep_zipf_mixed", seed=4, seconds=0.5)
    assert rc == 3 and out is None


def test_a_traced_slice_without_device_activity_is_taken_again(monkeypatch):
    """A profile with no device interval between its markers is taken
    again; three such slices fail the run rather than report busy 0."""
    import asyncio
    import types

    from portbench import harness

    reads = iter([0, 0, 5, 0, 0, 0])

    async def one(*a, **k):
        return dict(busy_ns=next(reads), recorded=2)

    monkeypatch.setattr(harness, "_one_traced_slice", one)
    cuda = types.SimpleNamespace(type="cuda")
    red = asyncio.run(harness.traced_slice(None, None, 1.0, 0, cuda, None, None))
    assert red["busy_ns"] == 5 and red["attempts"] == 3
    with pytest.raises(RuntimeError):
        asyncio.run(harness.traced_slice(None, None, 1.0, 0, cuda, None, None))
