"""The comparison's controls: the program with one guarantee its
configuration states broken underneath, which the comparison has to find.
The benchmark's own runs never use them.

- `dedup`: every key is charged at most once a batch (the rows after a
  key's first in a batch see its budget untouched and charge nothing), a
  per-batch shortcut that breaks "exact per key, every hit counted";
- `undercount`: the sketch tier reads one hit fewer than its counters
  hold, which breaks "never counts fewer hits than it was charged".

    python3 portbench/control.py --control dedup --workload <name> --seeds 1,2,3 --seconds 5

runs the cell once a seed, each in its own process, on the card, and
prints each run's result line.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


class Control:
    """A patch in the harness's protocol (harness.run_cell)."""

    def __init__(self, name: str):
        if name not in ("dedup", "undercount"):
            raise ValueError(f"unknown control {name!r}")
        self.name = name

    def before_boot(self):
        import torch

        import gubernator_tpu_torch.core.kernels as kernels

        if self.name == "dedup":
            # no segmented prefix: every row sees its group's budget whole,
            # and the group's charged total reads 0
            kernels._seg_scan = lambda is_leader, values: torch.zeros_like(values)
        else:
            orig = kernels._sketch_lookup

            def lookup(sketch, kh, wid):
                est, idxs = orig(sketch, kh, wid)
                return torch.clamp_min(est - 1, 0), idxs

            kernels._sketch_lookup = lookup

    def on_backend(self, backend):
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--control", required=True, choices=("dedup", "undercount"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.child:
        sys.path[0] = str(Path.cwd())
        from portbench import run

        run.T_START = time.monotonic()
        return run.main(["--workload", a.workload, "--seed", a.seeds, "--seconds", str(a.seconds),
                         "--trace", "0"], patch=Control(a.control))
    rc = 0
    for seed in a.seeds.split(","):
        r = subprocess.run([sys.executable, __file__, "--child", "--control", a.control,
                            "--workload", a.workload, "--seeds", seed, "--seconds", str(a.seconds)],
                           capture_output=True, text=True)
        last = r.stdout.strip().splitlines()[-1:] or [""]
        print(f"control {a.control} {a.workload} seed {seed} rc {r.returncode}: {last[0]}", flush=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
