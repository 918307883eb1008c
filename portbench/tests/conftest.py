"""Fixtures of the benchmark's own tests: a benchmark folder in a temporary
directory that holds the cut-down configurations and traffic mixes of
`tiny/` beside the real streams and metric readers, and a runner that
drives a whole cell of it on the CPU (skipping only the look for a card)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def bench_dir(tmp_path):
    """(BENCHMARK.json path, benchmark folder) of a tiny benchmark."""
    root = tmp_path / "bench"
    shutil.copytree(HERE / "tiny", root)
    for sub in ("streams", "metrics"):
        shutil.copytree(PORTBENCH / sub, root / sub)
    return root / "BENCHMARK.json", root


@pytest.fixture
def run_cell(bench_dir, capsys):
    """run_cell(workload, seed=..., seconds=..., trace=0, patch=None) ->
    (exit code, result dict or None) on the CPU."""
    from portbench import run

    bench_file, root = bench_dir

    def go(workload, seed=7, seconds=1.0, trace=0, patch=None):
        run.T_START = time.monotonic()
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", bench_file=bench_file, root=root,
                      patch=patch)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)

    return go
