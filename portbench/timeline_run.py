"""Run one cell as portbench/run.py does, with the port's batch timeline
(serve/stages.py) armed across the traced slice, and print run.py's
result line with what the timeline adds:

    python3 portbench/timeline_run.py --workload <name> --seed <n> --seconds <s> \
        [--armed-window 1] [--timeline-out <file.json>]

from the root of a checkout; the slice is always traced. The result line
gains the idle_* metrics (metrics/idle_*_share.deep.py) and
`breakdown.idle_gaps_by_span` and `.idle_gaps_by_path`, and a `timeline`
object: the slice's idle ns, their split by category (`idle_by`) and
along the path of the batch that ended each gap (`idle_by_path`,
timeline.attribute_paths), the records kept and dropped,
the graph launches of the slice and the shares of them inside `launch`
spans and inside any span that launches a graph. `--armed-window 1` keeps
the timeline armed over the whole measured window too (the armed cost:
compare its served rate and `dispatch_ms.deep` with a run without it) and
reports the window's records a second. `--timeline-out` writes the slice's
records, on the profiler's clock, and its device intervals (start, end)
to a file.

run.py's harness stays as it is: this runner wraps its traced slice and
its window's collection clock from outside.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(Path.cwd())  # the checkout's root, as run.py sets it

#: records a traced slice may keep (about 30 a batch, 100-130 batches a second)
SLICE_CAPACITY = 1 << 18
#: records an armed 51 s window may keep
WINDOW_CAPACITY = 1 << 21
IDLE_METRICS = ("idle_submit_share.deep", "idle_fetch_share.deep", "idle_loop_share.deep",
                "idle_unattributed_share.deep")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--armed-window", type=int, choices=(0, 1), default=0)
    p.add_argument("--timeline-out", default=None)
    return p.parse_args(argv)


def install(armed_window: bool, out: dict):
    """Wrap the harness's traced slice (arm the timeline around it, keep
    the trace's device intervals and runtime calls, add what
    timeline.read_slice gives to the slice's reduction) and, with
    `armed_window`, its window's collection clock (arm across the
    window). `out` receives the window's record count. Returns the
    function that puts the harness back."""
    from gubernator_tpu_torch.serve.stages import STAGES, wall_records
    from portbench import harness, timeline, trace

    one_slice = harness._one_traced_slice
    reduce = trace.reduce
    gc_clock = harness.GcClock

    async def traced(*args, **kw):
        seen = {}

        def keep(dev, host, lo, hi):
            seen.update(dev=dev, host=host, lo=lo, hi=hi)
            return reduce(dev, host, lo, hi)

        STAGES.arm_timeline(SLICE_CAPACITY)
        trace.reduce = keep
        try:
            red = await one_slice(*args, **kw)
        finally:
            trace.reduce = reduce
            tl = STAGES.disarm_timeline()
        red.update(timeline.read_slice(wall_records(tl), seen["dev"], seen["host"],
                                       seen["lo"], seen["hi"]))
        red.update(dropped=tl["dropped"], lo=seen["lo"], hi=seen["hi"],
                   dev=[[s, e] for s, e, _name in seen["dev"]])
        return red

    harness._one_traced_slice = traced
    if armed_window:
        class ArmedGcClock(harness.GcClock):
            def __enter__(self):
                out["t0"] = time.monotonic()
                STAGES.arm_timeline(WINDOW_CAPACITY)
                return super().__enter__()

            def __exit__(self, *exc):
                super().__exit__(*exc)
                tl = STAGES.disarm_timeline()
                out.update(records=len(tl["records"]), dropped=tl["dropped"],
                           seconds=time.monotonic() - out["t0"])

        harness.GcClock = ArmedGcClock

    def undo():
        harness._one_traced_slice, harness.GcClock = one_slice, gc_clock

    return undo


def main(argv=None, **run_kw) -> int:
    """Run a cell; `run_kw` (device, bench_file, root, patch) go to
    run.main, for the benchmark's own tests."""
    args = parse(argv)
    from portbench import run

    run.T_START = T_START
    window: dict = {}
    undo = install(bool(args.armed_window), window)
    result_of = run.result_of
    kept = {}

    def with_timeline(r, spec, workload, trace, chips):
        out = result_of(r, spec, workload, trace, chips)
        p = r["profile"]
        for name in IDLE_METRICS:
            v = spec.reader(name).read(r)
            if v is not None:
                out["metrics"][name] = dict(value=float(v), unit="share")
        out["breakdown"]["idle_gaps_by_span"] = p["idle_gaps_by_span"]
        out["breakdown"]["idle_gaps_by_path"] = p["idle_gaps_by_path"]
        out["timeline"] = dict(
            idle_ns=p["idle_ns"], idle_by=p["idle_by"], idle_by_path=p["idle_by_path"],
            records=len(p["timeline"]),
            dropped=p["dropped"], graph_launches=p["graph_launches"],
            launch_share=p["launch_share"], graph_owned_share=p["graph_owned_share"],
            window=dict(window, records_per_s=window["records"] / window["seconds"])
            if window else None,
        )
        out["checks"] = out.pop("checks")  # checks stay last, as run.py prints them
        kept.update(timeline=p["timeline"], dev=p["dev"], lo=p["lo"], hi=p["hi"])
        return out

    run.result_of = with_timeline
    argv = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", "1"]
    try:
        rc = run.main(argv, **run_kw)
    finally:
        run.result_of = result_of
        undo()
    if rc == 0 and args.timeline_out:
        Path(args.timeline_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.timeline_out).write_text(json.dumps(kept))
    return rc


if __name__ == "__main__":
    sys.exit(main())
