"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, key
stream and metric readers are found by the names BENCHMARK.json gives
(portbench/spec.py). The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device, (with --trace 1) breakdown,
and last `checks`, each number the comparison held beside its limit; the
same checks close standard error. Exits 2 without a result where the card
is missing, 3 where JAX or the JAX package got loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path.cwd()
if __name__ == "__main__":
    sys.path[0] = str(REPO)  # the checkout's root, not portbench/ (whose names would shadow)

FORBIDDEN = ("jax", "jaxlib", "flax", "gubernator_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (gubernator_tpu_torch is not gubernator_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_of(run: dict, spec, workload: dict, trace: bool, chips: int) -> dict:
    """The result line from a finished run: the cell's metrics by their
    readers, the device, the breakdown and the checks."""
    from portbench.check import compare

    correct, checks = compare(run)
    metrics = {}
    for m in spec.metrics(workload["name"], trace):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    w = run["window"]
    device = dict(platform="gpu" if run["kind"] != "cpu" else "cpu", kind=run["kind"], count=chips,
                  memory_peak_bytes=run["memory_peak_bytes"])
    out = dict(correct=bool(correct), attempted=int(w["sent"]), failed=int(run["totals"]["failed"]),
               metrics=metrics, device=device)
    prof = run.get("profile")
    if trace and prof is not None:
        device.update(busy_s=prof["busy_ns"] / 1e9, window_s=prof["window_ns"] / 1e9)
        out["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    out["checks"] = checks
    return out


def main(argv=None, device=None, bench_file=None, root=None, patch=None) -> int:
    """Run a cell. `device`, `bench_file`, `root` and `patch` are for the
    harness's own tests and controls: by default the cell runs on the card
    (and fails without one), from ./BENCHMARK.json."""
    args = parse(argv)
    from portbench.spec import HERE, Spec

    spec = Spec(Path(bench_file) if bench_file else REPO / "BENCHMARK.json", Path(root) if root else HERE)
    workload = spec.workload(args.workload)
    chips = int(workload["chips"])
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    cfg = spec.config(workload["config"])
    traffic = spec.traffic(workload["traffic"])
    stream = spec.stream(traffic["stream"])
    from portbench.harness import run_cell

    run = asyncio.run(run_cell(cfg, traffic, stream, args.seed, args.seconds, bool(args.trace),
                               device, T_START, patch=patch))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}; the benchmark runs without JAX", file=sys.stderr)
        return 3
    w = run["window"]
    print(f"portbench: setup {run['setup_s']:.3f} s (backend warmup {run['warmup_s']:.3f} s, "
          f"prefill {run['prefill_s']:.3f} s); window {w['seconds']} s, {w['sent']} requests, "
          f"{sum(1 for sp in run['spans'] if sp['opened'])} spans recorded", file=sys.stderr)
    print("portbench: window host " + json.dumps(dict(
        process_cpu_per_s=w["process_cpu_per_s"], gc2_s=w["gc2_s"], gc2_count=w["gc2_count"],
        generator_wait_s=w["generator_wait_s"], promoter=w["promoter"], replays=w.get("replays"),
        replay_s=w.get("replay_s"), replay_rows=w.get("replay_rows"),
        start_unix=w["start_unix"], rows_per_second=w["per_second"])), file=sys.stderr)
    t0 = time.monotonic()
    out = result_of(run, spec, workload, bool(args.trace), chips)
    part = run["compare_s"]
    print(f"portbench: the comparison took {time.monotonic() - t0:.3f} s (spans {part['spans']:.3f} s, "
          f"start {part['start']:.3f} s)", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit: {c['must'].replace('_', ' ')} {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
