"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (gubernator_tpu_torch) through the entry points a user
calls (the engine, the serving core, the daemon's doors and a cluster of
nodes forwarding to each other), at two of the repo's deployments:

- exact tier, "Zipfian 10M keys, 1 GiB store" (GUBER_SKETCH=0): a slot
  store of int32[2^21, 128] (GUBER_STORE_MIB=1024), zipf(a=1.2) ids over
  10M keys, token bucket hits=1 limit=1000 duration=60 s;
- two-tier, the default decide path at the "zipf100m_sketch_tier"
  deployment (cli/bench_serving.py:run_zipf100m): GUBER_STORE_MIB=1024
  with the sketch on and auto-sized, so a v2 int32[2, 2^25] sketch
  (256 MiB) is carved out and the exact tier is int32[2^20, 128]
  (805,306,368 bytes on the card in all); the exact tier is prefilled
  with 1.25x its capacity of sequential ids (640 batches), then zipf(1.2)
  ids over 100M keys, token bucket hits=1 limit=1000 duration=600 s;
  first at the engine (TorchEngine), then through the serving core.

All use device batches of 32,768 (the ladder buckets_for_limit(32768)).
Phases, one JSON line each:

1. build     compile csrc/writeback.cu with nvcc (seconds);
2. kernel    the writeback kernel against its plain version, bit for bit,
             at the exact path's shape (2^21 buckets, G of a zipf batch),
             the sweep's own regime (4096 buckets, B=32768) and the
             two-tier path's shape (2^20 buckets, G of a zipf100m batch):
             ms / plain_ms / library_ms are device time per call of a run
             of back-to-back calls (CUDA events around the run, over the
             count), cycling through 8 batches whose rows exceed the L2
             cache; bound_ms is bytes over the H100's 3.35 TB/s;
3. walk      get_rate_limits: a limit-2 key goes 1 -> 0 -> OVER_LIMIT;
4. main      exact tier: 3 batches held against the same port on the CPU
             (identical outputs and store bytes), 50 timed, then a profile;
5. two_tier  prefill, 3 checked batches (token, sliding, GCRA) held
             against the CPU in responses, stats, store and sketch bytes,
             50 timed token batches, a promote of the 1,024 most frequent
             sketch-served keys held against the CPU, a profile, then one
             batch after the first 32 prefill batches expired (dead token
             victims fold into the sketch), held against the CPU;
6. serving   the serving core booted as cli/bench_serving.py boots the
             JAX one (config_from_env -> make_backend -> warmup ->
             Instance -> start, this node alone on the ring): the same
             prefill through batcher.decide_arrays in groups of 4,096
             from 8 fillers, a timed window of >= 10 s of zipf groups
             from 16 workers (decisions/s, mean device batch, promoter,
             shed cache, queue stats, stage times, beside the two-tier
             engine phase's decisions/s), a profiled 1 s window, and a
             checked leg: 24 request-object groups, a sketch-served tail
             key walk and one promoter tick, identical to a CPU Instance
             started from the card's state;
7. doors     `python -m gubernator_tpu_torch.cli.daemon` as a subprocess
             with the serving phase's env on free ports: the boot log's
             store tiers (805,306,368 bytes) and HealthCheck, a limit-2
             walk through gRPC (the port's V1Client) and through the HTTP
             JSON gateway, a timed window of >= 10 s of 16 AsyncV1Client
             callers sending GetRateLimits of 1,000 zipf keys (decisions/s,
             RPC p50/p99, mean device batch from /metrics, stage means
             from /v1/debug/stages, the daemon's kernel launches, decides
             and install chunks over the window from /v1/debug/stats),
             /metrics' histogram and store gauges, 2 s
             of the same traffic under the daemon's /v1/debug/profile
             (torch.profiler: the device's idle share), then SIGTERM:
             the drain's steps and exit 0;
8. cluster   a 3-node port LocalCluster in this process, each node the
             same deployment on the card, on ports drawn so that each
             node's ring arc owns 20-50% of the keys: a checked leg of
             16 requests through node 0's gRPC door (all four algorithms, BATCHING,
             NO_BATCHING and GLOBAL keys, most owned by other nodes), one
             at a time under a pinned clock with the GLOBAL rounds run by
             explicit calls, identical, owner metadata included, to a
             3-node CPU LocalCluster of the port on the same addresses,
             and every node answering a token GLOBAL key as its owner
             does; then a timed window of forwarded RPCs through node 0,
             its 16 callers in a client process of their own (this same
             script with --rpc-window), off the nodes' event loop;
9. kernels   the contract line over every kernel of the path.

The writeback kernel's launch count is set to 0 before each in-process
path and read after it; each must equal that path's decides plus
window-install (and, in the cluster, gossip-charge) chunks. The daemon's
count lives in its own process: it is read from /v1/debug/stats just
before and just after the doors window, and the difference must equal
the window's decides plus install and gossip chunks, read the same way.
Every window requires every answer to be a decision: one per-item error
(a failed forward, an open breaker) fails the run.
Prints the card's name and power limit (nvidia-smi) on a line of its own
and, last, {"ok": true, "device": {...}}. Exits non-zero, printing no
result, if there is no CUDA device, if the port is not importable, or if
any phase fails. Imports nothing of JAX or of gubernator_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM3 at 3.35 TB/s (the roofline for bytes)
HBM_BYTES_PER_S = 3.35e12
T0 = 1_700_000_000_000

# the repo's zipf key recipe (gubernator_tpu/cli/keystreams.py:34-65)
ZIPF_A = 1.2
MIX_MUL = 0x9E3779B97F4A7C15
MIX_XOR = 0xDEADBEEFCAFEF00D
KEY_SPACE = 10_000_000
KEY_SPACE_100M = 100_000_000
DEPTH = 32_768
HITS, LIMIT, DURATION = 1, 1000, 60_000
DURATION_100M = 600_000
CHECKED_BATCHES = 3
TIMED_BATCHES = 50
PROFILED_BATCHES = 10
PROMOTED_KEYS = 1024
EXPIRED_PREFILL = 32  # prefill batches dead at the two-tier eviction batch
KERNEL_SETS = 8  # batches cycled per kernel timing run
KERNEL_CALLS = 192  # calls per timing run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def hash_ids(ids: np.ndarray) -> np.ndarray:
    return (ids.astype(np.uint64) * np.uint64(MIX_MUL)) ^ np.uint64(MIX_XOR)


def zipf_hashes(n: int, seed: int = 42, key_space: int = KEY_SPACE) -> np.ndarray:
    return hash_ids(np.random.default_rng(seed).zipf(ZIPF_A, n) % key_space)


def spin_up(seconds: float = 0.5) -> None:
    """Keep the card busy long enough to leave its idle clocks."""
    x = torch.ones(1 << 24, device="cuda")
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(20):
            x.mul_(1.0000001)
        torch.cuda.synchronize()


def sleep_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per device millisecond."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(20_000_000)
    e.record()
    e.synchronize()
    return 20_000_000 / s.elapsed_time(e)


def single_call_ms(fn, reps: int = 15) -> float:
    """Median device time of ONE call, CUDA events around it (a spin
    queued ahead keeps the host's launch gap out). For one ~4 us launch
    this includes the event records' own cost: kept under its own name."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(calls: list, cycles_per_ms: float, n: int = KERNEL_CALLS) -> float:
    """Device ms per call of `n` back-to-back calls cycling through
    `calls`: CUDA events around the whole run, over the count. A sleep
    queued ahead of the start event lasts longer than the host takes to
    enqueue the run, so the run executes back to back on the card and the
    host's launch gaps stay outside it. A run whose start event had
    already passed when the host finished enqueueing (the sleep ran out:
    clocks above the calibration's, or a slow host) is run again with a
    longer sleep."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls[i % len(calls)]()
    sleep_ms = 2 * (time.perf_counter() - t0) * 1e3 + 2
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        start.record()
        for i in range(n):
            calls[i % len(calls)]()
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / n
        sleep_ms *= 4
    fail("run_ms: the host never enqueued a run before the card reached it")


def host_us(fn, n: int = 200) -> float:
    """Mean host time (us) to launch one call, device drained after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def way_disjoint_rows(bkt: np.ndarray, ways: int, rng) -> np.ndarray:
    """Delta rows whose duplicate-bucket runs take distinct ways, values
    over all of int32, 30% zero rows (non-writers)."""
    B = bkt.shape[0]
    lead = np.r_[True, bkt[1:] != bkt[:-1]]
    run = np.arange(B) - np.maximum.accumulate(np.where(lead, np.arange(B), 0))
    vals = rng.integers(-(2**31), 2**31 - 1, (B, 8), dtype=np.int64).astype(np.int32)
    vals[rng.random(B) < 0.3] = 0
    drow = np.zeros((B, ways, 8), np.int32)
    drow[np.arange(B), run % ways] = vals
    return drow.reshape(B, ways * 8)


def group_buckets(ladder, buckets: int, kh: np.ndarray) -> np.ndarray:
    """The decide's writeback stream for one batch: the bucket of every
    padded group slot (engine.pad_request_sorted's group structure)."""
    from gubernator_tpu_torch.core.engine import pad_request_sorted
    from gubernator_tpu_torch.core.store import bucket_index, key_hash_tensor

    n = kh.shape[0]
    ones = np.ones(n, np.int64)
    _req, _order, groups = pad_request_sorted(
        ladder, buckets, kh, ones, ones, ones,
        np.zeros(n, np.int32), np.zeros(n, bool), with_groups=True,
    )
    return bucket_index(key_hash_tensor(groups.key_hash), buckets).numpy()


def kernel_case(name: str, buckets: int, bkts: list, seed: int, cyc: float) -> dict:
    """The kernel against its plain version on the first of `bkts`, then
    per-call device times of runs cycling through all of them."""
    from gubernator_tpu_torch.core.writeback import writeback_add, writeback_add_plain

    W = 128
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randint(
        -(2**31), 2**31 - 1, (buckets, W), dtype=torch.int32, device="cuda",
        generator=gen,
    )
    sets = []
    for b in bkts:
        sets.append((
            torch.from_numpy(b).cuda(),
            torch.from_numpy(way_disjoint_rows(b, W // 8, rng)).cuda(),
            int(np.unique(b).shape[0]),
        ))
    bkt, drow, _u = sets[0]
    want = writeback_add_plain(data.clone(), bkt, drow)
    got = writeback_add(data.clone(), bkt, drow)
    torch.cuda.synchronize()
    touched = torch.unique(bkt).long()
    max_abs_err = int((got[touched].long() - want[touched].long()).abs().max().item())
    if not torch.equal(got, want) or max_abs_err != 0:
        fail(f"kernel {name}: writeback_add disagrees with writeback_add_plain")
    del got, want
    G = int(bkt.shape[0])
    nbytes = [s[0].shape[0] * W * 4 + s[0].shape[0] * 4 + 2 * s[2] * W * 4 for s in sets]
    mean_bytes = float(np.mean(nbytes))
    work = data.clone()
    fns = dict(
        ms=[lambda b=b, d=d: writeback_add(work, b, d) for b, d, _ in sets],
        plain_ms=[lambda b=b, d=d: writeback_add_plain(work, b, d) for b, d, _ in sets],
        library_ms=[lambda b=b, d=d: work.index_add_(0, b, d) for b, d, _ in sets],
    )
    spin_up()
    samples = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
        for k in order:
            samples[k].append(run_ms(fns[k], cyc))
    times = {k: statistics.median(v) for k, v in samples.items()}
    bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
    out = dict(
        shape=name, buckets=buckets, G=G, touched_rows=sets[0][2],
        bytes_mean=mean_bytes, sets=len(sets), calls_per_run=KERNEL_CALLS,
        max_abs_err=max_abs_err, **times,
        ms_samples=samples["ms"],
        l2_warm_ms=run_ms(fns["ms"][:1], cyc),  # one batch repeated
        single_call_ms=single_call_ms(lambda: writeback_add(work, bkt, drow)),
        bound_ms=bound_ms, bound_by="bytes", share_of_bound=bound_ms / times["ms"],
        host_us=host_us(lambda: writeback_add(work, bkt, drow)),
        plain_host_us=host_us(lambda: writeback_add_plain(work, bkt, drow)),
    )
    del data, work, sets, fns
    torch.cuda.empty_cache()
    return out


def profile_batches(eng, pool, fields, now: int, step: int):
    """torch.profiler over len(pool) batches: device busy and idle share,
    the top device events, and the writeback kernel's time per launch.
    Returns (that dict, the last `now`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for kh in pool:
            now += step
            eng.decide_arrays(kh, *fields, now)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_profile(prof, wall_us, len(pool)), now


def device_profile(prof, wall_us: float, nb: int) -> dict:
    """Device busy and idle share over `wall_us`, the top device events,
    busy shares by kind and the writeback kernel's time per launch, from
    a finished torch.profiler run that decided `nb` batches."""
    rows = []  # device-side events only (kernels, copies, memsets)
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    wb = [r for r in rows if "writeback_add_kernel" in r[0]]
    if not wb:
        fail("torch.profiler saw no writeback kernel in the traced batches")
    if busy <= 0 or nb <= 0:
        fail("torch.profiler recorded no device time for the traced batches")

    def share(*words):
        return sum(r[1] for r in rows if any(w in r[0] for w in words)) / busy

    return dict(
        batches=nb, wall_us=wall_us, device_busy_us=busy,
        device_idle_share=1 - busy / wall_us,
        device_busy_us_per_batch=busy / nb,
        device_events_per_batch=sum(r[2] for r in rows) / nb,
        writeback_device_us_per_call=wb[0][1] / wb[0][2],
        writeback_launches=wb[0][2],
        busy_share=dict(
            writeback=share("writeback_add_kernel"),
            gathers=share("index", "gather", "Gather"),
            scatter_reduce=share("scatter"),
            scans=share("scan", "cumsum", "cummax", "cummin", "Scan"),
            copies=share("Memcpy", "Memset", "copy"),
        ),
        top=[dict(name=k[:90], device_us=d, count=c) for k, d, c in rows[:20]],
    )


def check_responses(out, limit: int, min_reset: int, what: str) -> None:
    """Finite responses of the expected shape and range; a token batch's
    resets all lie after `now` (pass now), GCRA's may not (pass 0)."""
    status, rlimit, remaining, reset = out
    if not (
        status.shape == (DEPTH,) and np.isin(status, (0, 1)).all()
        and (rlimit == limit).all() and (remaining >= 0).all()
        and (remaining <= limit).all() and (reset > min_reset).all()
    ):
        fail(f"{what}: responses out of range")


def same_as_cpu(eng, cpu, out, ref, what: str, stats=None) -> None:
    for a, b, name in zip(out, ref, ("status", "limit", "remaining", "reset")):
        if not np.array_equal(a, b):
            fail(f"{what}: {name} differs from the CPU run")
    if stats is not None and stats[0] != stats[1]:
        fail(f"{what}: stats differ from the CPU run: {stats}")
    if not torch.equal(eng.store.data.cpu(), cpu.store.data):
        fail(f"{what}: store bytes differ from the CPU run")
    if eng.sketch is not None and not torch.equal(eng.sketch.data.cpu(), cpu.sketch.data):
        fail(f"{what}: sketch bytes differ from the CPU run")


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def timed_batches(eng, pool, fields, now: int, step: int, what: str):
    """Decide each batch of `pool` (token bucket) through decide_submit /
    decide_wait, host-timed with the card drained before each, responses
    checked. Returns (batch ms, per-batch stats deltas, the last `now`)."""
    batch_ms, per_batch = [], []
    for i, kh in enumerate(pool):
        now += step
        before = eng.stats.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.decide_wait(eng.decide_submit(kh, *fields, now))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        per_batch.append(delta(eng.stats.snapshot(), before))
        check_responses(out, LIMIT, now, f"{what} batch {i}")
    return batch_ms, per_batch, now


def rate_fields(ladder, slots: int, pool, fields, batch_ms, per_batch) -> dict:
    """The numbers both paths' main lines share: decisions/s, batch median
    and p99, groups per batch, and the host prep (pad_request_sorted)
    median over the first 10 batches of `pool`."""
    from gubernator_tpu_torch.core.engine import pad_request_sorted

    prep_ms = []
    for kh in pool[:10]:
        t0 = time.perf_counter()
        pad_request_sorted(ladder, slots, kh, *fields, with_groups=True)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(
        timed_batches=len(batch_ms),
        decisions_per_s=len(batch_ms) * DEPTH / (sum(batch_ms) / 1e3),
        batch_ms_median=statistics.median(batch_ms),
        batch_ms_p99=float(np.percentile(batch_ms, 99)),
        host_prep_ms_median=statistics.median(prep_ms),
        groups_per_batch_mean=float(np.mean([b["hits"] + b["misses"] for b in per_batch])),
    )


def exact_path(card: str, ladder, writeback) -> dict:
    """The exact-tier 1 GiB zipf10m path (GUBER_SKETCH=0)."""
    from gubernator_tpu_torch import RateLimitReq, Status
    from gubernator_tpu_torch.core.engine import TorchEngine
    from gubernator_tpu_torch.core.store import derive_store_config, store_to_numpy

    config = derive_store_config(mib=1024)
    eng = TorchEngine(config, buckets=ladder)
    t0 = time.monotonic()
    eng.warmup(now=T0)
    warm_s = time.monotonic() - t0
    writeback.writeback_add.launches = 0  # count this path only
    decides = 0

    walk = []
    for i in range(1, 4):
        r = eng.get_rate_limits(
            [RateLimitReq(name="smoke", unique_key="walk", hits=1, limit=2,
                          duration=60_000)], now=T0 + i)[0]
        decides += 1
        walk.append(r)
    ok_walk = (
        [r.remaining for r in walk] == [1, 0, 0]
        and [r.status for r in walk] == [Status.UNDER_LIMIT, Status.UNDER_LIMIT, Status.OVER_LIMIT]
        and len({r.reset_time for r in walk}) == 1
        and walk[0].reset_time == T0 + 1 + 60_000
    )
    emit(dict(phase="walk", ok=ok_walk, remaining=[r.remaining for r in walk],
              status=[int(r.status) for r in walk], reset_time=[r.reset_time for r in walk]))
    if not ok_walk:
        fail("get_rate_limits walk did not go 1 -> 0 -> OVER_LIMIT with a stable reset")

    # the CPU reference run of the same port starts from the card's state
    cpu = TorchEngine(config, buckets=ladder, device="cpu")
    cpu.load_state(store_to_numpy(eng.store), eng.clock.epoch)

    n_batches = CHECKED_BATCHES + TIMED_BATCHES
    pool = zipf_hashes(n_batches * DEPTH).reshape(n_batches, DEPTH)
    fields = (np.full(DEPTH, HITS, np.int64), np.full(DEPTH, LIMIT, np.int64),
              np.full(DEPTH, DURATION, np.int64), np.zeros(DEPTH, np.int32),
              np.zeros(DEPTH, bool))
    now = T0 + 10
    torch.cuda.reset_peak_memory_stats()
    for i in range(CHECKED_BATCHES):
        now += 2
        out = eng.decide_arrays(pool[i], *fields, now)
        decides += 1
        check_responses(out, LIMIT, now, f"exact check batch {i}")
        ref = cpu.decide_arrays(pool[i], *fields, now)
        same_as_cpu(eng, cpu, out, ref, f"exact batch {i}")
        emit(dict(phase="check", path="exact", batch=i, cpu_identical=True))
    del cpu
    timed = pool[CHECKED_BATCHES:]
    batch_ms, per_batch, now = timed_batches(eng, timed, fields, now, 2, "exact")
    decides += len(batch_ms)
    launches = writeback.writeback_add.launches
    if launches != decides or launches == 0:
        fail(f"exact path: writeback kernel launched {launches} times for {decides} decides")
    emit(dict(
        phase="main", path="exact", card=card, store_shape=list(eng.store.data.shape),
        store_bytes=eng.store.data.numel() * 4, batch=DEPTH, warmup_s=warm_s,
        **rate_fields(ladder, config.slots, timed, fields, batch_ms, per_batch),
        decides=decides, kernel_launches=launches,
        stats=eng.stats.snapshot(),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    ))
    prof, now = profile_batches(
        eng, pool[CHECKED_BATCHES:CHECKED_BATCHES + PROFILED_BATCHES], fields, now, 2
    )
    emit(dict(phase="profile", path="exact", card=card, **prof))
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, decides=decides)


def two_tier_path(card: str, ladder, writeback) -> dict:
    """The default decide path (sketch on) at the zipf100m deployment."""
    from gubernator_tpu_torch.core.engine import TorchEngine
    from gubernator_tpu_torch.core.sketches import derive_two_tier_config, sketch_footprint_bytes

    config, skc = derive_two_tier_config(1024)
    resident = config.slots * config.rows * 32 + sketch_footprint_bytes(skc)
    if (config.slots, config.rows, skc.rows, skc.width, skc.counter_bytes) != (
        1 << 20, 16, 2, 1 << 25, 4
    ) or resident != 805_306_368:
        fail(f"GUBER_STORE_MIB=1024 two-tier derived {config} + {skc}")
    eng = TorchEngine(config, buckets=ladder, sketch=skc)
    on_card = eng.store.data.numel() * 4 + eng.sketch.data.numel() * 4
    t0 = time.monotonic()
    eng.warmup(now=T0)
    warm_s = time.monotonic() - t0
    top = max(ladder)
    writeback.writeback_add.launches = 0  # count this path only
    decides = install_chunks = 0
    ones = np.ones(DEPTH, np.int64)
    tok = (ones * HITS, ones * LIMIT, ones * DURATION_100M, np.zeros(DEPTH, np.int32),
           np.zeros(DEPTH, bool))

    # prefill: 1.25x the exact tier's capacity of sequential ids
    # (cli/bench_serving.py:_prefill_sequential)
    n_ids = int(config.slots * config.rows * 1.25)
    now = T0
    t0 = time.monotonic()
    for c in range(n_ids // DEPTH):
        now += 1
        eng.decide_arrays(hash_ids(np.arange(c * DEPTH, (c + 1) * DEPTH)), *tok, now)
        decides += 1
    torch.cuda.synchronize()
    prefill = dict(ids=n_ids, batches=n_ids // DEPTH, seconds=time.monotonic() - t0,
                   stats=eng.stats.snapshot())
    emit(dict(phase="prefill", path="two_tier", card=card, **prefill))

    n_batches = CHECKED_BATCHES + TIMED_BATCHES + PROFILED_BATCHES + 1
    pool = zipf_hashes(n_batches * DEPTH, key_space=KEY_SPACE_100M).reshape(n_batches, DEPTH)

    # checked batches: token, sliding, GCRA against the CPU from the card's state
    cpu = TorchEngine(config, buckets=ladder, device="cpu", sketch=skc)
    cpu.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch,
                   eng.sketch.data.cpu().numpy())
    for i, algo in enumerate((0, 2, 3)):
        now += 1
        fields = tok[:3] + (np.full(DEPTH, algo, np.int32), tok[4])
        sb, cb = eng.stats.snapshot(), cpu.stats.snapshot()
        out = eng.decide_arrays(pool[i], *fields, now)
        decides += 1
        ref = cpu.decide_arrays(pool[i], *fields, now)
        d_gpu, d_cpu = delta(eng.stats.snapshot(), sb), delta(cpu.stats.snapshot(), cb)
        check_responses(out, LIMIT, now if algo == 0 else 0, f"two-tier check {i}")
        same_as_cpu(eng, cpu, out, ref, f"two-tier check batch {i} (algo {algo})",
                    stats=(d_gpu, d_cpu))
        if d_gpu["dropped"] <= 0:
            fail(f"two-tier check batch {i}: no sketch-served groups")
        emit(dict(phase="check", path="two_tier", batch=i, algo=algo, cpu_identical=True,
                  stats=d_gpu))
    del cpu

    # timed token batches
    timed = pool[CHECKED_BATCHES:CHECKED_BATCHES + TIMED_BATCHES]
    torch.cuda.reset_peak_memory_stats()
    batch_ms, per_batch, now = timed_batches(eng, timed, tok, now, 1, "two-tier")
    decides += len(batch_ms)
    peak = torch.cuda.max_memory_allocated()
    main = dict(
        phase="main", path="two_tier", card=card,
        store_shape=list(eng.store.data.shape), sketch_shape=list(eng.sketch.data.shape),
        sketch_dtype=str(eng.sketch.data.dtype), bytes_on_card=on_card, batch=DEPTH,
        warmup_s=warm_s, **rate_fields(ladder, config.slots, timed, tok, batch_ms, per_batch),
        dropped_per_batch_mean=float(np.mean([b["dropped"] for b in per_batch])),
        evictions_per_batch_mean=float(np.mean([b["evictions"] for b in per_batch])),
        stats=eng.stats.snapshot(), max_memory_allocated=peak,
    )
    if min(b["dropped"] for b in per_batch) <= 0:
        fail("two-tier timed batches: a batch had no sketch-served groups")

    # promote the most frequent sketch-served keys of the timed stream: a
    # key of the stream with no live exact entry was decided by the sketch
    uniq, counts = np.unique(timed.ravel(), return_counts=True)
    by_freq = uniq[np.argsort(-counts, kind="stable")]
    keys = by_freq[~eng.live_mask(by_freq, now)][:PROMOTED_KEYS]
    if keys.shape[0] < PROMOTED_KEYS:
        fail(f"only {keys.shape[0]} sketch-served keys to promote")
    cpu = TorchEngine(config, buckets=ladder, device="cpu", sketch=skc)
    cpu.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch,
                   eng.sketch.data.cpu().numpy())
    now += 1
    lim = np.full(PROMOTED_KEYS, LIMIT, np.int64)
    dur = np.full(PROMOTED_KEYS, DURATION_100M, np.int64)
    t0 = time.perf_counter()
    got = eng.promote_from_sketch(keys, lim, dur, now)
    promote_ms = (time.perf_counter() - t0) * 1e3
    install_chunks += -(-int(got[0].sum()) // top)
    ref = cpu.promote_from_sketch(keys, lim, dur, now)
    for a, b, name in zip(got, ref, ("installed", "estimate", "reset", "over")):
        if not np.array_equal(a, b):
            fail(f"promote: {name} differs from the CPU run")
    if not got[0].all() or int(got[1].min()) < 1:
        fail("promote: a sketch-served key was not installed or has no estimate")
    # two promoted keys of one full bucket: the second install drops
    live_share = float(eng.live_mask(keys, now).mean())
    if live_share < 0.9:
        fail(f"promote: only {live_share:.3f} of the promoted keys are live exact entries")
    if not torch.equal(eng.store.data.cpu(), cpu.store.data):
        fail("promote: store bytes differ from the CPU run")
    now += 1
    k1 = np.ones(PROMOTED_KEYS, np.int64)
    pf = (k1 * HITS, lim, dur, np.zeros(PROMOTED_KEYS, np.int32), np.zeros(PROMOTED_KEYS, bool))
    sb, cb = eng.stats.snapshot(), cpu.stats.snapshot()
    out = eng.decide_arrays(keys, *pf, now)
    decides += 1
    ref = cpu.decide_arrays(keys, *pf, now)
    same_as_cpu(eng, cpu, out, ref, "decide after promote",
                stats=(delta(eng.stats.snapshot(), sb), delta(cpu.stats.snapshot(), cb)))
    expected = np.maximum(LIMIT - got[1] - HITS, 0)
    if not np.array_equal(out[2], expected):
        fail("decide after promote: remaining is not limit - estimate - hits")
    del cpu
    emit(dict(phase="promote", path="two_tier", keys=PROMOTED_KEYS,
              installed=int(got[0].sum()), estimate_min=int(got[1].min()),
              estimate_max=int(got[1].max()), live_share=live_share, promote_ms=promote_ms,
              install_chunks=install_chunks, cpu_identical=True))

    profiled = pool[CHECKED_BATCHES + TIMED_BATCHES:-1]
    prof, now = profile_batches(eng, profiled, tok, now, 1)
    decides += len(profiled)
    emit(dict(phase="profile", path="two_tier", card=card, **prof))

    # eviction -> sketch fold at full size: move the clock past the expiry
    # of the first EXPIRED_PREFILL prefill batches (a few % of the exact
    # tier), so creates in buckets holding one of those recycle a dead
    # token victim and fold its consumed hit into the sketch at the
    # current window, while creates in the other buckets still drop to
    # the sketch. Held against the CPU like the checked batches.
    now = T0 + 1 + EXPIRED_PREFILL + DURATION_100M
    expired = hash_ids(np.arange(EXPIRED_PREFILL * DEPTH))
    exp_dur = np.full(expired.shape[0], DURATION_100M, np.int64)
    est_before = eng.sketch_estimates(expired, exp_dur, now)
    cpu = TorchEngine(config, buckets=ladder, device="cpu", sketch=skc)
    cpu.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch,
                   eng.sketch.data.cpu().numpy())
    sb, cb = eng.stats.snapshot(), cpu.stats.snapshot()
    out = eng.decide_arrays(pool[-1], *tok, now)
    decides += 1
    ref = cpu.decide_arrays(pool[-1], *tok, now)
    d_gpu, d_cpu = delta(eng.stats.snapshot(), sb), delta(cpu.stats.snapshot(), cb)
    # prefill batch EXPIRED_PREFILL's windows end at `now` itself, still live
    check_responses(out, LIMIT, now - 1, "two-tier eviction batch")
    same_as_cpu(eng, cpu, out, ref, "two-tier eviction batch", stats=(d_gpu, d_cpu))
    del cpu
    # a folded prefill key's current-window estimate grew by its consumed
    # hit; other keys' estimates move only on a collision in both rows
    # with this batch's few updates (older windows' counts stay as noise,
    # so the estimate alone does not tell)
    folded = int((eng.sketch_estimates(expired, exp_dur, now) > est_before).sum())
    if d_gpu["evictions"] <= 0 or folded <= 0 or d_gpu["dropped"] <= 0:
        fail(f"two-tier eviction batch: {d_gpu['evictions']} evictions, "
             f"{folded} folded keys, {d_gpu['dropped']} sketch-served groups")
    emit(dict(phase="check", path="two_tier", batch="eviction", algo=0,
              cpu_identical=True, folded_keys=folded, stats=d_gpu))

    launches = writeback.writeback_add.launches
    if launches != decides + install_chunks or launches == 0:
        fail(f"two-tier path: writeback kernel launched {launches} times for "
             f"{decides} decides + {install_chunks} install chunks")
    emit(dict(main, decides=decides, install_chunks=install_chunks, kernel_launches=launches))
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, decides=decides, install_chunks=install_chunks,
                decisions_per_s=main["decisions_per_s"])


# -- the serving phase: the port's serving core at the zipf100m deployment --

SERVING_ADDR = "127.0.0.1:9990"  # this node's ring address (never dialed)
SERVING_ENV = {  # cli/bench_serving.py:747-761 (run_zipf100m's conf_for)
    "GUBER_BACKEND": "tpu",
    "GUBER_DEVICE_BATCH_LIMIT": str(DEPTH),
    "GUBER_DEVICE_DEEP_BATCH": "1",
    "GUBER_STORE_MIB": "1024",
    "GUBER_STORE_TARGET_KEYS": "100000000",
    "GUBER_SKETCH": "1",
    "GUBER_GRPC_ADDRESS": SERVING_ADDR,
}
SERVING_BYTES = 805_306_368  # int32[2^20, 128] store + int32[2, 2^25] sketch
GROUP = 4096  # rows per caller group (bench_serving's --group)
FILLERS = 8  # concurrent prefill callers (_prefill_sequential)
WINDOW_S = 10.0  # the timed window (_measure_window)
PROFILE_S = 1.0  # the profiled window
ZIPF_POOL = 1 << 22  # pre-hashed zipf pool the window's workers slide over
CHECKED_GROUPS = 24  # request-object groups held against the CPU
CHECKED_ITEMS = 1000  # at most, per group (MAX_BATCH_SIZE)
CHECKED_KEYS = 5000  # distinct key ids the checked groups draw from
DEEP_SHARE = 0.995  # the window's mean device batch, at least, over DEPTH
RAMP_S = 0.5  # a window's start, left out of its mean device batch


def serving_path(card: str, writeback, engine_rate: float) -> dict:
    """The port's serving core on the card, booted as the JAX package's
    serving bench boots its stack (cli/bench_serving.py `_boot_stack`):
    config_from_env -> make_backend -> warmup -> Instance -> start, with
    this node alone on the ring. Then the prefill, the timed window, a
    profiled window and the checked leg against a CPU Instance."""
    import asyncio

    return asyncio.run(_serving(card, writeback, engine_rate))


async def _serving(card, writeback, engine_rate):
    import asyncio

    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.api.types import PeerInfo
    from gubernator_tpu_torch.serve.backends import make_backend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.instance import Instance
    from gubernator_tpu_torch.serve.stages import STAGES

    conf = config_from_env(dict(SERVING_ENV))
    backend = make_backend(conf)
    eng = backend.engine
    on_card = eng.store.data.numel() * 4 + eng.sketch.data.numel() * 4
    geometry = dict(store_shape=list(eng.store.data.shape),
                    sketch_shape=list(eng.sketch.data.shape),
                    sketch_dtype=str(eng.sketch.data.dtype), bytes_on_card=on_card,
                    ladder=list(eng.buckets))
    if (geometry["store_shape"] != [1 << 20, 128] or geometry["sketch_shape"] != [2, 1 << 25]
            or eng.sketch.data.dtype != torch.int32 or on_card != SERVING_BYTES):
        fail(f"serving: the zipf100m env derived {geometry}")
    t0 = time.monotonic()
    await asyncio.to_thread(backend.warmup)
    warm_s = time.monotonic() - t0
    inst = Instance(conf, backend)
    inst.start()
    await inst.set_peers([PeerInfo(address=SERVING_ADDR, is_owner=True)])
    if inst.promoter is None or inst.shed is None:
        fail("serving: the instance built no promoter or no shed cache")
    emit(dict(phase="boot", path="serving", card=card, warmup_s=warm_s, **geometry,
              fetch_depth=inst.batcher.fetch_depth, prep_threads=inst.batcher.prep_threads,
              prep_at_arrival=inst.batcher.prep_at_arrival,
              deep_batch=inst.batcher.deep_batch))

    # every window install (and gossip charge) is one writeback launch per
    # ladder-top chunk; the engine counts the chunks
    chunks0 = eng.install_chunks + eng.gossip_chunks
    writeback.writeback_add.launches = 0  # count this path only
    base = backend.stats()

    # prefill: 1.25x the exact tier's capacity of sequential ids, in
    # groups from 8 concurrent fillers (_prefill_sequential)
    capacity = eng.config.slots * eng.config.rows
    n_ids = int(capacity * 1.25)
    n_groups = -(-n_ids // GROUP)
    ones = np.ones(GROUP, np.int64)
    tok = dict(hits=ones, limit=ones * LIMIT, duration=ones * DURATION_100M,
               algo=np.zeros(GROUP, np.int32))

    async def filler(w: int):
        for c in range(w, n_groups, FILLERS):
            out = await inst.batcher.decide_arrays(
                dict(tok, key_hash=hash_ids(np.arange(c * GROUP, (c + 1) * GROUP))))
            if not (out[0] == 0).all():
                fail(f"serving prefill group {c}: a fresh id was refused")

    t0 = time.monotonic()
    await asyncio.gather(*[filler(w) for w in range(FILLERS)])
    prefill = dict(ids=n_groups * GROUP, groups=n_groups, seconds=time.monotonic() - t0,
                   stats=delta(backend.stats(), base),
                   promoter=inst.promoter.stats())
    emit(dict(phase="prefill", path="serving", card=card, **prefill))

    # the timed window: zipf(1.2) over 100M keys from 16 workers
    pool = zipf_hashes(ZIPF_POOL, key_space=KEY_SPACE_100M)
    STAGES.reset()
    p0, shed0 = inst.promoter.stats(), inst.shed.hits
    window = await serving_window(inst, backend, pool, WINDOW_S)
    window.update(
        promoter=inst.promoter.stats(),
        promoter_window=delta(inst.promoter.stats(), p0),
        shed_hits=inst.shed.hits - shed0, shed=inst.shed.stats(),
        stages=STAGES.snapshot()["stages"],
        engine_two_tier_decisions_per_s=engine_rate,
        serving_over_engine=window["decisions_per_s"] / engine_rate if engine_rate else None,
    )
    if window["mean_device_batch"] < DEEP_SHARE * DEPTH:
        fail(f"serving window: mean device batch {window['mean_device_batch']} "
             f"is below {DEEP_SHARE} of the {DEPTH} rung")
    if window["dropped_creates"] <= 0 or window["promoter"]["promotions"] <= 0:
        fail(f"serving window: {window['dropped_creates']} sketch-served creates, "
             f"{window['promoter']['promotions']} promotions")

    window["alone_ms"] = serving_stages_alone(backend, pool)
    emit(dict(phase="window", path="serving", card=card, **window))

    b0 = backend.stats()["batches"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await serving_window(inst, backend, pool, PROFILE_S)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit(dict(phase="profile", path="serving", card=card,
              **device_profile(tp, wall_us, backend.stats()["batches"] - b0)))

    checked = await serving_checked_leg(inst, conf, backend)

    decides = backend.stats()["batches"] - base["batches"]
    launches = writeback.writeback_add.launches
    await inst.stop()
    chunks = eng.install_chunks + eng.gossip_chunks - chunks0
    if launches != decides + chunks or launches == 0:
        fail(f"serving path: writeback kernel launched {launches} times for "
             f"{decides} decides + {chunks} install chunks")
    emit(dict(phase="main", path="serving", card=card, **geometry, warmup_s=warm_s,
              batch=DEPTH, group_rows=GROUP, **window,
              prefill_seconds=prefill["seconds"], checked=checked,
              decides=decides, install_chunks=chunks, kernel_launches=launches,
              max_memory_allocated=torch.cuda.max_memory_allocated()))
    del eng, backend, inst
    torch.cuda.empty_cache()
    return dict(launches=launches, decides=decides, install_chunks=chunks)


def batch_histogram() -> tuple:
    """(rows, batches) the batcher's device_batch_size histogram holds."""
    from gubernator_tpu_torch.serve import metrics

    samples = {x.name: x.value for x in metrics.DEVICE_BATCH_SIZE.collect()[0].samples}
    return samples["device_batch_size_sum"], samples["device_batch_size_count"]


async def serving_window(inst, backend, pool, seconds: float) -> dict:
    """One timed window of pre-hashed zipf groups through the batcher's
    array door (cli/bench_serving.py `_measure_window`): enough workers
    to keep ~2 deep batches of groups outstanding, every response
    checked, the batcher's queue sampled every 50 ms. The mean device
    batch counts the batches answered from RAMP_S into the window to its
    end: the first flush from an idle pipeline, and the last batch that
    the workers who stopped at the end left short, are not deep
    accumulation's to fill."""
    import asyncio

    workers = max(8, 2 * DEPTH // GROUP)
    stop_at = time.monotonic() + seconds
    done = [0]
    base = backend.stats()
    ones = np.ones(GROUP, np.int64)
    fields = dict(hits=ones, limit=ones * LIMIT, duration=ones * DURATION_100M,
                  algo=np.zeros(GROUP, np.int32))

    async def worker(w: int):
        i = w * 101
        while time.monotonic() < stop_at:
            off = (i * GROUP) % (pool.shape[0] - GROUP)
            i += 1
            status, limit, remaining, reset = await inst.batcher.decide_arrays(
                dict(fields, key_hash=pool[off:off + GROUP]))
            if not (np.isin(status, (0, 1)).all() and (limit == LIMIT).all()
                    and (remaining >= 0).all() and (remaining <= LIMIT).all()
                    and (reset > 0).all()):
                fail("serving window: responses out of range")
            done[0] += GROUP

    samples = []
    marks = []

    async def sampler():
        while time.monotonic() < stop_at:
            samples.append(inst.batcher.queue_stats())
            await asyncio.sleep(0.05)

    async def steady():
        await asyncio.sleep(RAMP_S)
        marks.append(batch_histogram())
        await asyncio.sleep(max(0.0, stop_at - time.monotonic()))
        marks.append(batch_histogram())

    t0 = time.monotonic()
    await asyncio.gather(sampler(), steady(), *[worker(w) for w in range(workers)])
    elapsed = time.monotonic() - t0
    d = delta(backend.stats(), base)
    rows, batches = (int(b - a) for a, b in zip(*marks))
    return dict(
        decisions_per_s=done[0] / elapsed,
        mean_device_batch=rows / batches if batches else 0.0,
        steady_batches=batches,
        mean_device_batch_all=done[0] / d["batches"] if d["batches"] else 0.0,
        device_batches=d["batches"], rows=done[0], seconds=elapsed, workers=workers,
        dropped_creates=d["dropped"], evictions=d["evictions"],
        queue_stats=dict(
            samples=len(samples),
            depth_max=max(q["depth"] for q in samples),
            depth_mean=float(np.mean([q["depth"] for q in samples])),
            oldest_age_s_max=max(q["oldest_age_s"] for q in samples),
            prep_backlog_max=max(q["prep_backlog"] for q in samples),
        ),
    )


def serving_stages_alone(backend, pool, reps: int = 5) -> dict:
    """Median host ms of the submit thread's stages for one window-shaped
    batch (8 groups of 4,096 zipf rows), run with no serving thread
    busy: a group's arrival prep, the merge of the 8 runs, the dispatch
    and the fetch. Beside the in-window stage means they show what the
    window's contention adds. The dispatched batches decide for real
    (counted decides and launches)."""
    ones = np.ones(GROUP, np.int64)
    groups = [dict(hits=ones, limit=ones * LIMIT, duration=ones * DURATION_100M,
                   algo=np.zeros(GROUP, np.int32),
                   key_hash=pool[(i + 1000) * GROUP:(i + 1001) * GROUP])
              for i in range(DEPTH // GROUP)]
    out = {k: [] for k in ("prep_group", "merge", "dispatch", "fetch")}
    for _ in range(reps):
        t0 = time.perf_counter()
        runs = [backend.prep_group(g) for g in groups]
        out["prep_group"].append((time.perf_counter() - t0) * 1e3 / len(groups))
        t0 = time.perf_counter()
        merged = backend.merge_prepped(runs)
        out["merge"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = backend.decide_submit_merged(merged)
        out["dispatch"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        backend.decide_wait_arrays(handle)
        out["fetch"].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def _checked_groups(rng, types):
    """CHECKED_GROUPS request-object groups over CHECKED_KEYS key ids:
    per key a fixed algorithm (even ids token, odd ids one of the other
    three), limit and duration, so frozen token refusals shed; duplicates,
    hits-0 peeks and GLOBAL items throughout."""
    params = [
        (0 if k % 2 == 0 else 1 + k % 3, (2, 10, 1000)[k % 3], (1000, 60_000, 600_000)[k % 5 % 3])
        for k in range(CHECKED_KEYS)
    ]
    for _ in range(CHECKED_GROUPS):
        n = int(rng.integers(1, CHECKED_ITEMS + 1))
        ks = np.minimum(rng.zipf(1.2, n) - 1, CHECKED_KEYS - 1)
        hits = rng.choice([0, 1, 1, 1, 2, 5], n)
        glob = rng.random(n) < 0.1
        yield [
            types.RateLimitReq(
                name="smoke", unique_key=f"user{k}", hits=int(h),
                limit=params[k][1], duration=params[k][2],
                algorithm=types.Algorithm(params[k][0]),
                behavior=types.Behavior.GLOBAL if g else types.Behavior.BATCHING,
            )
            for k, h, g in zip(ks.tolist(), hits.tolist(), glob.tolist())
        ]


def _bucket_full(eng, kh: int, e_now: int) -> bool:
    """Every way of the key's bucket holds a live entry (so a create of
    this key drops to the sketch)."""
    from gubernator_tpu_torch.core.store import L_EXPIRE, L_TAG, LANES, bucket_index, key_hash_tensor

    b = int(bucket_index(key_hash_tensor(np.array([kh], np.uint64)), eng.config.slots)[0])
    row = eng.store.data[b].cpu().numpy().reshape(-1, LANES)
    return bool(((row[:, L_TAG] != 0) & (row[:, L_EXPIRE] >= e_now)).all())


async def serving_checked_leg(inst, conf, backend) -> dict:
    """The serving core on the card against a CPU Instance that starts
    from the card's state: the promoter's loop and the GLOBAL loops
    stopped (their work runs by explicit calls on both sides, so batch
    composition is the same), one pinned clock, the same request-object
    groups one await at a time, a sketch-served tail key walked to
    OVER_LIMIT, then one batch folded into both promoters and one
    flush_once each. Everything must be identical."""
    from collections import OrderedDict

    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch.core.hashing import slot_hash_batch
    from gubernator_tpu_torch.core.kernels import BatchRequest
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.instance import Instance
    from gubernator_tpu_torch.serve.promoter import SketchPromoter

    eng = backend.engine
    await inst.promoter.stop()
    await inst.global_mgr.stop()
    await inst.batcher.drain()
    torch.cuda.synchronize()
    cpu_backend = TorchBackend(eng.config, buckets=eng.buckets, sketch=eng.sketch_config,
                               device="cpu")
    cpu_backend.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch,
                           eng.sketch.data.cpu().numpy())
    cpu_backend.engine.reset_generation = eng.reset_generation
    cpu = Instance(conf, cpu_backend)
    cpu.start()
    await cpu.promoter.stop()
    await cpu.global_mgr.stop()
    await cpu.set_peers([types.PeerInfo(address=SERVING_ADDR, is_owner=True)])
    cpu.shed._entries = OrderedDict(inst.shed._entries)
    cpu.shed._snap = None
    real_now = types.millisecond_now
    pinned = [real_now() + 1]
    types.millisecond_now = lambda: pinned[0]
    try:
        for side in (inst, cpu):
            side.shed.reset_counters()
            side.shed.now_fn = types.millisecond_now
            side.promoter = SketchPromoter(conf, side)  # fresh, loop not started
        sg, sc = backend.stats(), cpu_backend.stats()
        rng = np.random.default_rng(17)
        items = 0
        token_keys = []
        for i, group in enumerate(_checked_groups(rng, types)):
            pinned[0] += int(rng.choice([0, 1, 7, 300]))
            a = await inst.get_rate_limits(group)
            b = await cpu.get_rate_limits(group)
            for x, y, r in zip(a, b, group):
                if (x.status, x.limit, x.remaining, x.reset_time, x.error, x.metadata) != (
                        y.status, y.limit, y.remaining, y.reset_time, y.error, y.metadata):
                    fail(f"serving checked group {i}: {r} -> card {x}, cpu {y}")
                if x.error or x.remaining < 0 or x.remaining > r.limit:
                    fail(f"serving checked group {i}: {r} -> {x}")
            await inst.global_mgr.drain()
            await cpu.global_mgr.drain()
            items += len(group)
            token_keys += [r for r in group if r.algorithm == 0 and r.hits > 0]
        # a new tail key with limit 2 in a bucket full of live entries: the
        # sketch decides it, 1 -> 0 -> OVER_LIMIT with one window-aligned reset
        e_now = int(eng.clock.to_engine(pinned[0]))
        name = next(f"tail{j}" for j in range(1000)
                    if _bucket_full(eng, int(slot_hash_batch([f"smoke_tail{j}"])[0]), e_now))
        walk, before = [], backend.stats()
        for _ in range(3):
            pinned[0] += 1
            req = [types.RateLimitReq(name="smoke", unique_key=name, hits=1, limit=2,
                                      duration=60_000)]
            x, y = (await inst.get_rate_limits(req))[0], (await cpu.get_rate_limits(req))[0]
            if (x.status, x.remaining, x.reset_time) != (y.status, y.remaining, y.reset_time):
                fail(f"serving tail walk: card {x}, cpu {y}")
            walk.append(x)
        window_end = int(eng.clock.from_engine(
            (int(eng.clock.to_engine(pinned[0])) // 60_000 + 1) * 60_000))
        walk_dropped = backend.stats()["dropped"] - before["dropped"]
        if ([w.remaining for w in walk] != [1, 0, 0]
                or [int(w.status) for w in walk] != [0, 0, 1]
                or {w.reset_time for w in walk} != {window_end} or walk_dropped < 3):
            fail(f"serving tail walk: {walk}, window end {window_end}, "
                 f"{walk_dropped} sketch-served")
        # one batch folded into both promoters' top-K, one tick each
        n = len(token_keys)
        fold = BatchRequest(
            key_hash=slot_hash_batch([r.hash_key() for r in token_keys]),
            hits=np.array([r.hits for r in token_keys], np.int32),
            limit=np.array([r.limit for r in token_keys], np.int32),
            duration=np.array([r.duration for r in token_keys], np.int32),
            algo=np.zeros(n, np.int32), gnp=np.zeros(n, bool), valid=np.ones(n, bool))
        for side in (inst, cpu):
            side.promoter.tracker.observe(fold)
            await side.promoter.flush_once()
        pg, pc = inst.promoter.stats(), cpu.promoter.stats()
        if pg != pc or pg["promotions"] <= 0:
            fail(f"serving promoter tick: card {pg}, cpu {pc}")
        dg, dc = delta(backend.stats(), sg), delta(cpu_backend.stats(), sc)
        if dg != dc or dg["dropped"] <= 0:
            fail(f"serving checked leg: stats card {dg}, cpu {dc}")
        if (inst.shed.stats() != cpu.shed.stats() or inst.shed._entries != cpu.shed._entries
                or inst.shed.hits <= 0):
            fail(f"serving checked leg: shed card {inst.shed.stats()}, cpu {cpu.shed.stats()}")
        if not torch.equal(eng.store.data.cpu(), cpu_backend.engine.store.data):
            fail("serving checked leg: store bytes differ from the CPU run")
        if not torch.equal(eng.sketch.data.cpu(), cpu_backend.engine.sketch.data):
            fail("serving checked leg: sketch bytes differ from the CPU run")
    finally:
        types.millisecond_now = real_now
        await cpu.stop()
    out = dict(groups=CHECKED_GROUPS, items=items, stats=dg, promoter_tick=pg,
               shed=inst.shed.stats(), tail_walk=[[w.remaining, int(w.status), w.reset_time]
                                                 for w in walk],
               cpu_identical=True)
    emit(dict(phase="check", path="serving", **out))
    return out


# -- the doors phase: one daemon booted the way users boot it -------------

DOORS_CALLERS = 16  # concurrent AsyncV1Client callers in the doors window
RPC_ITEMS = 1000  # items a GetRateLimits carries (reference maxBatchSize)
RPC_POOL = 64  # prebuilt requests the callers cycle through
BOOT_S = 600  # the daemon's boot (warmup of every rung) must end within


def free_ports(n: int) -> list:
    """n distinct ephemeral localhost ports (bind-then-release)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def http_json(url: str, body=None, timeout: float = 30.0):
    """(status, decoded JSON) of a GET, or of a POST of `body`."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_text(url: str, timeout: float = 30.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def metric_value(text: str, name: str) -> float:
    """The value of one unlabelled sample of a Prometheus exposition."""
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    fail(f"/metrics has no sample {name}")


def zipf_rpcs(rng, n_rpcs: int, name: str, behavior: int = 0) -> list:
    """Prebuilt GetRateLimitsReq of RPC_ITEMS zipf(1.2) keys over 100M
    each: token bucket, hits 1, limit 1000, 600 s."""
    from gubernator_tpu_torch.api.proto.gen import gubernator_pb2

    out = []
    for _ in range(n_rpcs):
        ids = rng.zipf(ZIPF_A, RPC_ITEMS) % KEY_SPACE_100M
        out.append(gubernator_pb2.GetRateLimitsReq(requests=[
            gubernator_pb2.RateLimitReq(
                name=name, unique_key=str(int(i)), hits=HITS, limit=LIMIT,
                duration=DURATION_100M, behavior=behavior)
            for i in ids.tolist()
        ]))
    return out


async def rpc_window(target: str, rpcs: list, seconds: float, callers: int) -> dict:
    """`callers` AsyncV1Client callers, each sending the prebuilt requests
    in turn, one awaited at a time, for `seconds`: items answered per
    second, the RPC latency on this process's clock, and how many times
    each request was sent. Every response is checked (count, values in
    range, no per-item error). Raises RuntimeError on a malformed answer
    or on the first error answer."""
    import asyncio

    from gubernator_tpu_torch.client import AsyncV1Client

    clients = [AsyncV1Client(target) for _ in range(callers)]
    lat, done, sent = [], [0], [0] * len(rpcs)
    stop_at = time.monotonic() + seconds

    async def caller(c, w: int):
        i = w * 7
        while time.monotonic() < stop_at:
            k = i % len(rpcs)
            req = rpcs[k]
            i += 1
            t0 = time.perf_counter()
            resp = await c.stub.GetRateLimits(req, timeout=60)
            lat.append((time.perf_counter() - t0) * 1e3)
            err = next((r.error for r in resp.responses if r.error), "")
            if err:
                n = sum(1 for r in resp.responses if r.error)
                raise RuntimeError(f"rpc window: {n} of {len(resp.responses)} answers "
                                   f"from {target} are errors, the first: {err!r}")
            bad = next((r for r in resp.responses if (
                r.remaining < 0 or r.remaining > LIMIT or r.limit != LIMIT)), None)
            if len(resp.responses) != len(req.requests) or bad is not None:
                raise RuntimeError(f"rpc window: {len(resp.responses)} answers from "
                                   f"{target}, {bad}")
            sent[k] += 1
            done[0] += len(resp.responses)

    try:
        t0 = time.monotonic()
        await asyncio.gather(*[caller(c, w) for w, c in enumerate(clients)])
        elapsed = time.monotonic() - t0
    finally:
        for c in clients:
            await c.close()
    return dict(decisions_per_s=done[0] / elapsed, items=done[0], errors=0,
                rpcs=len(lat), sent=sent, seconds=elapsed, callers=callers,
                items_per_rpc=RPC_ITEMS, rpc_ms_p50=float(np.percentile(lat, 50)),
                rpc_ms_p99=float(np.percentile(lat, 99)))


def rpc_window_main(argv: list) -> int:
    """`chip_smoke.py --rpc-window TARGET SECONDS SEED NAME`: rpc_window of
    DOORS_CALLERS callers over zipf_rpcs(SEED, NAME) in this process; one
    JSON line. Needs no card."""
    import asyncio

    target, seconds, seed, name = argv
    rpcs = zipf_rpcs(np.random.default_rng(int(seed)), RPC_POOL, name)
    out = asyncio.run(rpc_window(target, rpcs, float(seconds), DOORS_CALLERS))
    print(json.dumps(out), flush=True)
    return 0


def client_window(target: str, seed: int, name: str, seconds: float) -> dict:
    """rpc_window in a client process of its own (this script with
    --rpc-window), so that the callers' encode and decode leave this
    process's interpreter and event loop."""
    import os

    here = os.path.abspath(__file__)
    r = subprocess.run([sys.executable, here, "--rpc-window", target, str(seconds),
                        str(seed), name], cwd=os.path.dirname(here),
                       capture_output=True, text=True, timeout=seconds + 300)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        fail(f"the client process of the window against {target} exited "
             f"{r.returncode}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def quiet_stats(base: str) -> dict:
    """/v1/debug/stats once two reads 0.3 s apart agree on the kernel
    launches, the decides and the engine's chunks (a promoter tick or a
    batch in flight between the launch and its count would skew one
    read)."""
    def key(st):
        return (st["kernel_launches"]["writeback_add"], st["backend"]["batches"],
                st["engine_chunks"]["install_chunks"], st["engine_chunks"]["gossip_chunks"])

    _, prev = http_json(base + "/v1/debug/stats")
    for _ in range(50):
        time.sleep(0.3)
        _, cur = http_json(base + "/v1/debug/stats")
        if key(cur) == key(prev):
            return cur
        prev = cur
    fail(f"doors: /v1/debug/stats did not settle: {key(prev)}")


def doors_path(card: str) -> dict:
    """`python -m gubernator_tpu_torch.cli.daemon` as a subprocess with the
    serving phase's zipf100m env: boot checks, a limit-2 walk through gRPC
    and through the HTTP gateway, a timed window of RPCs, /metrics, then
    SIGTERM and its drain."""
    import asyncio
    import os
    import signal
    import threading

    from gubernator_tpu_torch.api.types import RateLimitReq, Status
    from gubernator_tpu_torch.client import V1Client

    g, h = free_ports(2)
    target, base = f"127.0.0.1:{g}", f"http://127.0.0.1:{h}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **SERVING_ENV)
    env.update(GUBER_GRPC_ADDRESS=target, GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.cli.daemon"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    log = []
    reader = threading.Thread(target=lambda: log.extend(proc.stdout), daemon=True)
    reader.start()

    def died(what):
        proc.kill()
        reader.join(5)
        sys.stderr.write("".join(log[-60:]))
        fail(f"doors: {what}")

    try:
        # the HTTP door opens last, after the warmup and the gRPC door
        while not any("HTTP listening" in ln for ln in log):
            if proc.poll() is not None:
                died(f"the daemon exited with {proc.returncode} during boot")
            if time.monotonic() - t0 > BOOT_S:
                died("the daemon did not open its doors in time")
            time.sleep(0.2)
        boot_s = time.monotonic() - t0
        client = V1Client(target)
        health = client.health_check(timeout=30)
        tiers = next((ln for ln in log if "store tiers:" in ln), "")
        import re

        m = re.search(r"exact (\d+) slots x (\d+) ways = (\d+) entries .*"
                      r"sketch (\d+)x(\d+) int(\d+)", tiers)
        if not m:
            died(f"no store-tiers line in the boot log: {tiers!r}")
        slots, ways, entries, rows, width, bits = (int(x) for x in m.groups())
        on_card = entries * 32 + rows * width * bits // 8
        if on_card != SERVING_BYTES or health.status != "healthy":
            died(f"boot: {on_card} bytes ({tiers.strip()}), health {health}")
        emit(dict(phase="boot", path="doors", card=card, boot_s=boot_s, bytes_on_card=on_card,
                  tiers=tiers.strip(), health=health.status, peer_count=health.peer_count))

        # the walks: a limit-2 key, 1 -> 0 -> OVER_LIMIT with one reset
        walk = [client.get_rate_limits([RateLimitReq(
            name="doors", unique_key="grpc_walk", hits=1, limit=2, duration=60_000)],
            timeout=30)[0] for _ in range(3)]
        body = {"requests": [{"name": "doors", "uniqueKey": "http_walk", "hits": 1,
                              "limit": 2, "duration": 60000}]}
        hwalk = [http_json(base + "/v1/GetRateLimits", body) for _ in range(3)]
        ok = ([r.remaining for r in walk] == [1, 0, 0]
              and [r.status for r in walk] == [Status.UNDER_LIMIT] * 2 + [Status.OVER_LIMIT]
              and len({r.reset_time for r in walk}) == 1
              and [s for s, _ in hwalk] == [200] * 3
              and [b["responses"][0]["remaining"] for _, b in hwalk] == ["1", "0", "0"]
              and [b["responses"][0]["status"] for _, b in hwalk]
              == ["UNDER_LIMIT", "UNDER_LIMIT", "OVER_LIMIT"]
              and len({b["responses"][0]["resetTime"] for _, b in hwalk}) == 1)
        emit(dict(phase="walk", path="doors", ok=ok,
                  grpc=[[r.remaining, int(r.status), r.reset_time] for r in walk],
                  http=[b["responses"][0] for _, b in hwalk]))
        if not ok:
            died("the gRPC or HTTP walk did not go 1 -> 0 -> OVER_LIMIT with one reset")
        client.close()

        # the timed window
        rpcs = zipf_rpcs(np.random.default_rng(5), RPC_POOL, "zipf100m")
        s0 = quiet_stats(base)
        m0 = http_text(base + "/metrics")
        http_json(base + "/v1/debug/stages?reset=1")
        window = asyncio.run(rpc_window(target, rpcs, WINDOW_S, DOORS_CALLERS))
        m1 = http_text(base + "/metrics")
        _, stages = http_json(base + "/v1/debug/stages")
        s1 = quiet_stats(base)
        rows = metric_value(m1, "device_batch_size_sum") - metric_value(m0, "device_batch_size_sum")
        nb = metric_value(m1, "device_batch_size_count") - metric_value(m0, "device_batch_size_count")
        for name in ("device_batch_size_bucket", "store_dropped_creates_total",
                     "store_evictions_total", "shed_entries", "batcher_queue_depth"):
            if name not in m1:
                died(f"/metrics lacks {name}")
        # the daemon's launches over the window, against its decides and
        # the promoter's install (and any gossip) chunks over the same span
        launches = (s1["kernel_launches"]["writeback_add"]
                    - s0["kernel_launches"]["writeback_add"])
        decides = s1["backend"]["batches"] - s0["backend"]["batches"]
        chunks = sum(s1["engine_chunks"][k] - s0["engine_chunks"][k]
                     for k in ("install_chunks", "gossip_chunks"))
        if nb <= 0 or decides <= 0 or launches != decides + chunks:
            died(f"the window: writeback kernel launched {launches} times for {decides} "
                 f"decides + {chunks} install and gossip chunks ({nb} device batches "
                 f"in /metrics)")
        window.update(device_batches=nb, mean_device_batch=rows / nb,
                      stages=stages["stages"],
                      shed=stages.get("shed_cache"),
                      kernel_launches=launches, decides=decides, chunks=chunks)
        emit(dict(phase="window", path="doors", card=card, **window))

        # a profiled stretch of the same traffic: the device's idle share
        window["profile"] = profiled_stretch(base, target, rpcs)
        emit(dict(phase="profile", path="doors", card=card, **window["profile"]))

        # SIGTERM: the drain lists its steps and the daemon exits 0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(10)
        drained = next((ln for ln in log if "drained in" in ln), "")
        steps = ("grpc", "http", "global_flush", "batcher")
        if rc != 0 or not all(f"'{s}'" in drained for s in steps):
            died(f"SIGTERM: exit {rc}, drain line {drained.strip()!r}")
        emit(dict(phase="drain", path="doors", exit_code=rc, drain=drained.strip()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    return dict(window, boot_s=boot_s, launches=launches)


def profiled_stretch(base: str, target: str, rpcs: list, ms: int = 2000) -> dict:
    """The daemon's /v1/debug/profile (torch.profiler) over `ms` of the
    window's traffic: device busy time from the kernels, copies and
    memsets of the Chrome trace it writes, and the idle share."""
    import asyncio
    import threading

    out = {}
    t = threading.Thread(target=lambda: out.update(
        http_json(f"{base}/v1/debug/profile?ms={ms}&name=doors", timeout=120)[1]))
    t.start()
    time.sleep(0.2)
    traffic = asyncio.run(rpc_window(target, rpcs, ms / 1000 + 0.5, DOORS_CALLERS))
    t.join()
    if "trace_dir" not in out:
        fail(f"doors: /v1/debug/profile answered {out}")
    with open(f"{out['trace_dir']}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in dev)
    if not dev:
        fail("doors: the profile recorded no device events")
    return dict(captured_ms=out["captured_ms"], device_busy_us=busy,
                device_events=len(dev), device_idle_share=1 - busy / (out["captured_ms"] * 1e3),
                decisions_per_s_profiled=traffic["decisions_per_s"])


# -- the cluster phase: forwarding on the card -------------------------------

CLUSTER_NODES = 3
CLUSTER_CHECKED_RPCS = 16
CLUSTER_KEYS = 4000  # distinct key ids the checked requests draw from


def _cluster_checked_rpcs(types, rng) -> list:
    """CLUSTER_CHECKED_RPCS request lists over CLUSTER_KEYS ids, each key
    at most once in a request (forwarded groups from one request reach
    their owners concurrently, so a key repeated inside one request would
    decide in an order the run picks); per key a fixed algorithm (all
    four), limit, duration and behavior (BATCHING, NO_BATCHING or
    GLOBAL: a key's GLOBAL replicas follow its owner only while every hit
    of it is GLOBAL); hits-0 peeks throughout."""
    params = [(k % 4, (2, 10, 1000)[k % 3], (1000, 60_000, 600_000)[k % 5 % 3],
               (0, 0, 1, 2)[k // 4 % 4]) for k in range(CLUSTER_KEYS)]
    w = 1.0 / np.arange(1, CLUSTER_KEYS + 1) ** 1.1
    out = []
    for _ in range(CLUSTER_CHECKED_RPCS):
        n = int(rng.integers(200, RPC_ITEMS + 1))
        ks = rng.choice(CLUSTER_KEYS, n, replace=False, p=w / w.sum())
        hits = rng.choice([0, 1, 1, 1, 2, 5], n)
        out.append([
            types.RateLimitReq(
                name="cluster", unique_key=f"user{k}", hits=int(h), limit=params[k][1],
                duration=params[k][2], algorithm=types.Algorithm(params[k][0]),
                behavior=types.Behavior(params[k][3]))
            for k, h in zip(ks.tolist(), hits.tolist())
        ])
    return out


def _settle_globals(cluster) -> None:
    """Two explicit GLOBAL rounds on every node (the loops are parked):
    non-owner hits reach their owners, then the owners broadcast."""
    for _ in range(2):
        for s in cluster.servers:
            cluster.run(s.instance.global_mgr.drain(), timeout=120)


def _cluster_leg(cluster, types, reqs_list, pinned) -> tuple:
    """The checked requests through node 0's gRPC door, one at a time
    under the pinned clock, GLOBAL settled after each; then one hits-0
    GLOBAL peek of every GLOBAL key at every node. Returns (the answers
    as tuples, the peeks per node)."""
    from gubernator_tpu_torch.client import V1Client

    rng = np.random.default_rng(19)
    answers = []
    with V1Client(cluster.peer_at(0)) as c:
        for reqs in reqs_list:
            pinned[0] += int(rng.choice([0, 1, 7, 300, 61_000]))
            resps = c.get_rate_limits(reqs, timeout=120)
            answers.append([(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
                             tuple(sorted(r.metadata.items()))) for r in resps])
            _settle_globals(cluster)
    gkeys = sorted({(r.unique_key, r.algorithm, r.limit, r.duration)
                    for reqs in reqs_list for r in reqs
                    if r.behavior == types.Behavior.GLOBAL})[:RPC_ITEMS]
    peek = [types.RateLimitReq(name="cluster", unique_key=k, hits=0, limit=lim,
                               duration=dur, algorithm=a, behavior=types.Behavior.GLOBAL)
            for k, a, lim, dur in gkeys]
    peeks = []
    for i in range(CLUSTER_NODES):
        with V1Client(cluster.peer_at(i)) as c:
            peeks.append([(int(r.status), r.remaining, r.error)
                          for r in c.get_rate_limits(peek, timeout=120)])
    return answers, peeks, peek


def cluster_path(card: str, writeback) -> dict:
    """A 3-node port LocalCluster in this process, each node the zipf100m
    deployment on the card: a checked leg through node 0's door (every
    item identical to a 3-node CPU LocalCluster's on the same addresses;
    GLOBAL converged on every node), then a timed window of RPCs."""
    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch.cluster import LocalCluster
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.core.hashing import ring_hash
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.stages import STAGES

    addrs = balanced_addresses(ring_hash, CLUSTER_NODES)
    # the three nodes share this process's interpreter and one event loop,
    # so a forward waits behind every node's host work, not its owner's
    # alone: the peer and gossip deadlines rise from the reference's
    # 500 ms, or the harness itself would trip the breakers. The GLOBAL
    # loops park (their 600 s window outlasts the phase): the checked leg
    # runs their rounds by explicit calls, so both clusters batch alike.
    env = dict(SERVING_ENV, GUBER_PEER_TIMEOUT_MS="10000", GUBER_GLOBAL_TIMEOUT_MS="10000",
               GUBER_GLOBAL_SYNC_WAIT_MS="600000")
    gpu = LocalCluster(addrs, env=env)
    t0 = time.monotonic()
    gpu.start(timeout=BOOT_S)
    boot_s = time.monotonic() - t0
    engines = [s.backend.engine for s in gpu.servers]
    on_card = sum(e.store.data.numel() * 4 + e.sketch.data.numel() * 4 for e in engines)
    if on_card != CLUSTER_NODES * SERVING_BYTES or any(e.device.type != "cuda" for e in engines):
        fail(f"cluster: {on_card} bytes on the card for {CLUSTER_NODES} nodes")
    for s in gpu.servers:  # the promoters' ticks run by no one here
        gpu.run(s.instance.promoter.stop())

    # every window install and every gossip-charge chunk is one launch
    def chunk_count():
        return sum(e.install_chunks + e.gossip_chunks for e in engines)

    chunks0 = chunk_count()
    base = [s.backend.stats()["batches"] for s in gpu.servers]
    writeback.writeback_add.launches = 0  # count this path only

    reqs_list = _cluster_checked_rpcs(types, np.random.default_rng(23))
    items = sum(len(r) for r in reqs_list)
    forwarded = sum(addrs[_owner(ring_hash, addrs, r.hash_key())] != addrs[0]
                    for reqs in reqs_list for r in reqs)
    real_now = types.millisecond_now
    pinned = [real_now() + 1]
    types.millisecond_now = lambda: pinned[0]
    try:
        for s in gpu.servers:
            s.instance.shed.now_fn = types.millisecond_now
        p0 = pinned[0]
        got, got_peeks, peek = _cluster_leg(gpu, types, reqs_list, pinned)
    finally:
        types.millisecond_now = real_now

    # the timed window through node 0 (real clock, fresh keys), its
    # callers in a client process, off the nodes' loop and interpreter
    STAGES.reset()
    window = client_window(addrs[0], 6, "cluster_zipf", WINDOW_S)
    window["stages"] = STAGES.snapshot()["stages"]  # the three nodes' together
    # the share of the items sent that node 0 forwarded: each prebuilt
    # request's forwarded items, weighted by how often it was sent
    rpcs = zipf_rpcs(np.random.default_rng(6), RPC_POOL, "cluster_zipf")
    fwd = [sum(_owner(ring_hash, addrs, f"cluster_zipf_{r.unique_key}") != 0
               for r in q.requests) for q in rpcs]
    fwd_share = sum(n * f for n, f in zip(window["sent"], fwd)) / window["items"]
    decides = sum(s.backend.stats()["batches"] - b for s, b in zip(gpu.servers, base))
    chunks = chunk_count() - chunks0
    launches = writeback.writeback_add.launches
    epochs = [e.clock.epoch for e in engines]
    per_node = [s.backend.stats() for s in gpu.servers]
    gpu.stop()
    del engines
    torch.cuda.empty_cache()
    if launches != decides + chunks or launches == 0:
        fail(f"cluster path: writeback kernel launched {launches} times for {decides} "
             f"decides + {chunks} install and gossip chunks")

    # the same leg on a CPU cluster of the port, on the same addresses
    conf = config_from_env(dict(env))
    store, skc = conf.store_config(), conf.sketch_config()
    ladder = buckets_for_limit(conf.device_batch_limit)

    def cpu_backend():
        b = TorchBackend(store, buckets=ladder, sketch=skc, device="cpu")
        b.warmup = lambda: None  # nothing to load; the epochs are copied below
        return b

    cpu = LocalCluster(addrs, env=env, backend_factory=cpu_backend)
    cpu.start(timeout=BOOT_S)
    try:
        for s, ep in zip(cpu.servers, epochs):
            s.backend.engine.clock.epoch = ep
            cpu.run(s.instance.promoter.stop())
        pinned[0] = p0
        types.millisecond_now = lambda: pinned[0]
        for s in cpu.servers:
            s.instance.shed.now_fn = types.millisecond_now
        want, want_peeks, _ = _cluster_leg(cpu, types, reqs_list, pinned)
    finally:
        types.millisecond_now = real_now
        cpu.stop()
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"cluster checked rpc {i} item {j}: card {a[j]}, cpu {b[j]}")
    if got_peeks != want_peeks:
        fail("cluster: the GLOBAL peeks differ from the CPU cluster's")
    # a replica is a token window (limit, remaining, reset): a node that
    # never served a leaky, sliding or GCRA key reads its replica as a
    # fresh window, in the JAX package too, so the owner's remaining is
    # required of every node for the token keys, and counted for the rest
    owners = [_owner(ring_hash, addrs, r.hash_key()) for r in peek]
    differ = {0: 0, 1: 0}
    for k, (r, o) in enumerate(zip(peek, owners)):
        token = int(r.algorithm == types.Algorithm.TOKEN_BUCKET)
        differ[token] += sum(got_peeks[i][k] != got_peeks[o][k] for i in range(CLUSTER_NODES))
    if differ[1]:
        fail(f"cluster: after one GLOBAL sync {differ[1]} token answers differ from the owner's")
    errors = sum(1 for a in got for x in a if x[4])
    with_owner = sum(1 for a in got for x in a if any(k == "owner" for k, _ in x[5]))
    if errors or with_owner == 0:
        fail(f"cluster checked leg: {errors} errors, {with_owner} answers naming an owner")
    checked = dict(rpcs=len(reqs_list), items=items, forwarded_items=forwarded,
                   owner_tagged=with_owner, global_keys=len(peek),
                   global_token_keys=sum(r.algorithm == 0 for r in peek),
                   global_non_token_answers_unlike_owner=differ[0], cpu_identical=True)
    emit(dict(phase="check", path="cluster", **checked))
    window.update(forwarded_share=fwd_share)
    emit(dict(phase="window", path="cluster", card=card, **window))
    out = dict(nodes=CLUSTER_NODES, addresses=addrs, boot_s=boot_s, bytes_on_card=on_card,
               decides=decides, chunks=chunks, kernel_launches=launches,
               per_node_stats=per_node)
    emit(dict(phase="main", path="cluster", card=card, **out))
    return dict(launches=launches, decides=decides, chunks=chunks, window=window)


def balanced_addresses(ring_hash, n: int, lo: float = 0.2, hi: float = 0.5) -> list:
    """n free localhost addresses whose ring arcs each own between `lo`
    and `hi` of the key space. The ring has one crc32 point per address,
    so the ports alone set each node's share: a draw where node 0 owns 2%
    would forward nearly every item and test the owner side of node 0
    hardly at all."""
    for _ in range(500):
        addrs = [f"127.0.0.1:{p}" for p in free_ports(n)]
        pts = sorted(ring_hash(a) for a in addrs)
        arcs = [((p - q) % (1 << 32)) / (1 << 32) for p, q in zip(pts, pts[-1:] + pts[:-1])]
        if all(lo <= a <= hi for a in arcs):
            return addrs
    fail(f"no draw of {n} free ports gave ring arcs between {lo} and {hi}")


def _owner(ring_hash, addrs: list, key: str) -> int:
    """Index of the ring owner of `key` (reference hash.go successor)."""
    points = sorted((ring_hash(a), i) for i, a in enumerate(addrs))
    h = ring_hash(key)
    return next((i for p, i in points if p >= h), points[0][1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on a GPU", file=sys.stderr)
        return 2
    # the port, from this checkout (fails here when run outside the repo)
    from gubernator_tpu_torch.core import writeback
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.core.sketches import derive_two_tier_config
    from gubernator_tpu_torch.core.store import derive_store_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda, count=torch.cuda.device_count()))

    # 1. build --------------------------------------------------------------
    t0 = time.monotonic()
    lib_path = writeback.build()
    writeback._load()
    log_path = lib_path.with_suffix(".log")
    emit(dict(phase="build", seconds=time.monotonic() - t0, library=lib_path.name,
              ptxas=[ln.strip() for ln in log_path.read_text().splitlines()
                     if "registers" in ln or "spill" in ln] if log_path.exists() else []))

    # 2. kernel vs plain at the paths' shapes ---------------------------------
    exact_cfg = derive_store_config(mib=1024)
    if (exact_cfg.rows, exact_cfg.slots) != (16, 1 << 21):
        fail(f"GUBER_STORE_MIB=1024 derived {exact_cfg}, not 2^21 x 16")
    two_cfg, _skc = derive_two_tier_config(1024)
    ladder = buckets_for_limit(DEPTH)
    spin_up()  # calibrate the sleep at working clocks, not idle ones
    cyc = sleep_cycles_per_ms()
    rng = np.random.default_rng(11)
    cases = {
        "exact": kernel_case(
            "exact path: 2^21 buckets, G of a zipf10m batch", exact_cfg.slots,
            [group_buckets(ladder, exact_cfg.slots, zipf_hashes(DEPTH, seed=7 + s))
             for s in range(KERNEL_SETS)], 1, cyc),
        "sweep": kernel_case(
            "sweep regime: 4096 buckets, B=32768", 4096,
            [np.sort(rng.integers(0, 4096, DEPTH)).astype(np.int32)
             for _ in range(KERNEL_SETS)], 2, cyc),
        "two_tier": kernel_case(
            "two-tier path: 2^20 buckets, G of a zipf100m batch", two_cfg.slots,
            [group_buckets(ladder, two_cfg.slots,
                           zipf_hashes(DEPTH, seed=7 + s, key_space=KEY_SPACE_100M))
             for s in range(KERNEL_SETS)], 3, cyc),
    }
    for path, c in cases.items():
        emit(dict(phase="kernel", kernel="writeback_add", path=path, card=card, **c))

    # 3-6. the paths, each with the launch count set to 0 before it ----------
    exact = exact_path(card, ladder, writeback)
    two = two_tier_path(card, ladder, writeback)
    serving = serving_path(card, writeback, two["decisions_per_s"])
    doors = doors_path(card)
    cluster = cluster_path(card, writeback)

    main_case = cases["two_tier"]
    emit({"kernels": [dict(
        name="writeback_add", route="cuda",
        source="gubernator_tpu_torch/csrc/writeback.cu",
        replaces="gubernator_tpu/core/pallas_sweep.py:97",
        launches=cluster["launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by="bytes",
        library_ms=main_case["library_ms"],
        launches_by_path={"exact": exact["launches"], "two_tier": two["launches"],
                          "serving": serving["launches"], "doors": doors["launches"],
                          "cluster": cluster["launches"]},
    )]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rpc-window"]:
        sys.exit(rpc_window_main(sys.argv[2:]))
    sys.exit(main())
