"""The tiny cells and a control on the card (skipped without one): the
recorder's state copies and the traced slice's marker kernels on a real device."""

from __future__ import annotations

import pytest

from portbench.control import Control


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_two.deep_zipf", "tiny_exact.deep_zipf_mixed"])
def test_tiny_cell_on_the_card(card, bench_dir, cell):
    """Each cell in a process of its own, as the benchmark runs it (a second
    torch.profiler session in one process may record no device activity)."""
    import json
    import subprocess
    import sys

    from conftest import REPO

    bench_file, root = bench_dir
    code = (f"import sys, time; sys.path.insert(0, {str(REPO)!r}); from portbench import run; "
            f"run.T_START = time.monotonic(); sys.exit(run.main(['--workload', {cell!r}, '--seed', "
            f"'2147483693', '--seconds', '2', '--trace', '1'], bench_file={str(bench_file)!r}, "
            f"root={str(root)!r}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out
    assert out["device"]["platform"] == "gpu" and 0 < out["device"]["busy_s"] <= out["device"]["window_s"], out


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct(card, bench_dir, capsys):
    import importlib
    import json
    import time

    import gubernator_tpu_torch.core.kernels as kernels
    from portbench import run

    bench_file, root = bench_dir
    run.T_START = time.monotonic()
    try:
        rc = run.main(["--workload", "tiny_two.deep_zipf", "--seed", "31", "--seconds", "2"],
                      bench_file=bench_file, root=root, patch=Control("undercount"))
    finally:
        importlib.reload(kernels)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is False
