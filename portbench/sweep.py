"""The open-loop sweep that finds a cell's knee: one boot of the cell's
configuration, then its traffic's open loop at each offered rate in turn.

    python3 portbench/sweep.py --config two_tier_zipf100m --traffic open_zipf_1000 \\
        --rates 600,1200,1800,2400 --seconds 4 --seed 1

(a configuration named in BENCHMARK.json and a traffic file's name; no
cell has to exist for them yet).

For each rate it prints one JSON line: requests offered, answered by the
end of the rate's window, p50 / p99 of the per-request times (due time to
answer), the generator's lag p99 and the mean device batch. The knee is
the highest rate at which every request offered was answered within the
window and the lag stayed bounded; the cell runs at a fixed fraction of it
(PERF.md records both numbers, the traffic file the chosen rate).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path


async def sweep(spec, config: str, traffic_name: str, rates, seconds: float, seed: int, device) -> list:
    from portbench.harness import Collector, batch_histogram, boot, open_loop
    from portbench.load import Load, open_schedule, percentile

    cfg, traffic = spec.config(config), spec.traffic(traffic_name)
    load = Load(traffic, cfg, spec.stream(traffic["stream"]), seed,
                start_id=int((cfg.get("prefill") or {}).get("ids", 0)))
    try:
        return await _sweep(cfg, traffic, load, rates, seconds, seed, device)
    finally:
        load.close()


async def _sweep(cfg, traffic, load, rates, seconds, seed, device) -> list:
    from portbench.harness import Collector, batch_histogram, boot, open_loop
    from portbench.load import open_schedule, percentile

    ctx = await boot(cfg, dict(cfg["check"], spans=[]), seed, device)
    inst = ctx["inst"]
    col = Collector(ctx["rec"], int(cfg["assumed"]["limit"]))
    k0 = [0]
    warm = open_schedule(float(rates[0]), float(traffic["warmup_s"]), int(traffic["gap_seed"]), seed)
    await open_loop(inst.batcher, load, col, warm, float(traffic["warmup_s"]), k0)
    out = []
    for i, rate in enumerate(rates):
        await inst.batcher.drain()
        col.reset()
        h0 = batch_histogram()
        due = open_schedule(float(rate), seconds, int(traffic["gap_seed"]), seed + i)
        t0 = time.monotonic()
        answered_by_end = []

        async def watch():
            await asyncio.sleep(seconds)
            answered_by_end.append(len(col.latency_s))

        await asyncio.gather(open_loop(inst.batcher, load, col, due, seconds, k0), watch())
        h1 = batch_histogram()
        row = dict(rate_rps=rate, offered_decisions_per_s=rate * load.rows, seconds=seconds,
                   offered=int(due.shape[0]), answered_by_end=answered_by_end[0],
                   answered=len(col.latency_s), failed=col.failed,
                   p50_ms=percentile(col.latency_s, 50) * 1e3, p99_ms=percentile(col.latency_s, 99) * 1e3,
                   lag_p99_ms=percentile(col.lag_s, 99) * 1e3,
                   mean_device_batch=(h1[0] - h0[0]) / max(1, h1[1] - h0[1]),
                   drain_s=time.monotonic() - t0 - seconds)
        print(json.dumps(row), flush=True)
        out.append(row)
    await inst.stop()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--rates", required=True, help="requests/s, comma separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    sys.path[0] = str(Path.cwd())
    import torch

    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("portbench sweep: no CUDA device", file=sys.stderr)
        return 2
    asyncio.run(sweep(Spec(Path.cwd() / "BENCHMARK.json"), a.config, a.traffic,
                      [float(r) for r in a.rates.split(",")], a.seconds, a.seed, "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
