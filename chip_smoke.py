"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (gubernator_tpu_torch) through the entry points a user
calls, at the repo's "Zipfian 10M keys, 1 GiB store" deployment (the
exact tier, GUBER_SKETCH=0): a slot store of int32[2^21, 128] (1 GiB,
GUBER_STORE_MIB=1024) resident on the card, zipf(a=1.2) key ids over 10M
keys, token bucket hits=1 limit=1000 duration=60 s, device batches of
32,768 (the ladder buckets_for_limit(32768)). Phases, one JSON line each:

1. build    compile csrc/writeback.cu with nvcc (seconds);
2. kernel   the writeback kernel against its plain version, bit for bit,
            at the main path's shape (2^21 buckets, G from a real zipf
            batch) and at the sweep's own regime (4096 buckets, B=32768),
            with ms / plain_ms / library_ms (CUDA events, median of 30
            calls timed in turns)
            and bound_ms (bytes over the H100's 3.35 TB/s);
3. walk     get_rate_limits: a limit-2 key goes 1 -> 0 -> OVER_LIMIT with
            a stable reset time;
4. main     53 batches through decide_submit/decide_wait with an
            advancing `now`; the first 3 are held against the same port
            run on the CPU (identical outputs and store bytes), the other
            50 timed; reports decisions/s, batch ms, groups per batch,
            kernel launches (must equal the decides of phases 3-4) and
            the store's bytes;
5. profile  torch.profiler over 10 more batches: device busy and idle
            share, the top device kernels;
6. kernels  the contract line over every kernel of the path.

Prints the card's name and power limit (nvidia-smi) on a line of its
own and, last, {"ok": true, "device": {...}}. Exits non-zero, printing
no result, if there is no CUDA device, if the port is not importable, or
if any phase fails. Imports nothing of JAX or of gubernator_tpu.
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

# the repo's zipf key recipe (gubernator_tpu/cli/keystreams.py:34-36)
ZIPF_A = 1.2
MIX_MUL = 0x9E3779B97F4A7C15
MIX_XOR = 0xDEADBEEFCAFEF00D
KEY_SPACE = 10_000_000
DEPTH = 32_768
HITS, LIMIT, DURATION = 1, 1000, 60_000
CHECKED_BATCHES = 3
TIMED_BATCHES = 50
PROFILED_BATCHES = 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def zipf_hashes(n: int, seed: int = 42) -> np.ndarray:
    ids = np.random.default_rng(seed).zipf(ZIPF_A, n) % KEY_SPACE
    return (ids.astype(np.uint64) * np.uint64(MIX_MUL)) ^ np.uint64(MIX_XOR)


def spin_up(seconds: float = 0.5) -> None:
    """Keep the card busy long enough to leave its idle clocks."""
    x = torch.ones(1 << 24, device="cuda")
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        for _ in range(20):
            x.mul_(1.0000001)
        torch.cuda.synchronize()


def time_samples(fn, reps: int = 15, warm: int = 3) -> list:
    """Device time (ms) of `reps` single calls, CUDA events around each.
    A ~0.5 ms spin queued ahead of the start event keeps the card busy
    while the host enqueues the call, so the events bracket the call's
    device work and not the host's launch latency (a ~50 us spin was too
    short on a slow host: the wrapper alone takes ~30 us there)."""
    for _ in range(warm):
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
    return times


def host_us(fn, n: int = 200) -> float:
    """Mean host time (us) to launch one call, device drained after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def time_in_turns(fns: dict) -> dict:
    """Median ms of each function, timed in turns (a, b, c, c, b, a) so
    that clock and cache drift falls on all of them alike."""
    samples = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            samples[k] += time_samples(fns[k])
    return {k: statistics.median(v) for k, v in samples.items()}


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


def kernel_case(name: str, buckets: int, bkt_np: np.ndarray, seed: int) -> dict:
    from gubernator_tpu_torch.core.writeback import writeback_add, writeback_add_plain

    W = 128
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randint(
        -(2**31), 2**31 - 1, (buckets, W), dtype=torch.int32, device="cuda",
        generator=gen,
    )
    bkt = torch.from_numpy(bkt_np).cuda()
    drow = torch.from_numpy(way_disjoint_rows(bkt_np, W // 8, rng)).cuda()
    want = writeback_add_plain(data.clone(), bkt, drow)
    got = writeback_add(data.clone(), bkt, drow)
    torch.cuda.synchronize()
    touched = torch.unique(bkt).long()
    max_abs_err = int(
        (got[touched].long() - want[touched].long()).abs().max().item()
    )
    if not torch.equal(got, want) or max_abs_err != 0:
        fail(f"kernel {name}: writeback_add disagrees with writeback_add_plain")
    del got, want
    G = int(bkt_np.shape[0])
    U = int(touched.numel())
    nbytes = G * W * 4 + G * 4 + 2 * U * W * 4
    work = data.clone()
    spin_up()
    out = dict(
        shape=name, buckets=buckets, G=G, touched_rows=U, bytes=nbytes,
        max_abs_err=max_abs_err,
        **time_in_turns(dict(
            ms=lambda: writeback_add(work, bkt, drow),
            plain_ms=lambda: writeback_add_plain(work, bkt, drow),
            library_ms=lambda: work.index_add_(0, bkt, drow),
        )),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        host_us=host_us(lambda: writeback_add(work, bkt, drow)),
        plain_host_us=host_us(lambda: writeback_add_plain(work, bkt, drow)),
    )
    del data, work
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on a GPU", file=sys.stderr)
        return 2
    # the port, from this checkout (fails here when run outside the repo)
    from gubernator_tpu_torch import RateLimitReq, Status
    from gubernator_tpu_torch.core import writeback
    from gubernator_tpu_torch.core.engine import (
        TorchEngine, buckets_for_limit, pad_request_sorted,
    )
    from gubernator_tpu_torch.core.store import (
        bucket_index, derive_store_config, key_hash_tensor, store_to_numpy,
    )

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

    # 2. kernel vs plain at the path's shapes --------------------------------
    config = derive_store_config(mib=1024)
    if (config.rows, config.slots) != (16, 1 << 21):
        fail(f"GUBER_STORE_MIB=1024 derived {config}, not 2^21 x 16")
    ladder = buckets_for_limit(DEPTH)
    kh0 = zipf_hashes(DEPTH, seed=7)
    ones = np.ones(DEPTH, np.int64)
    _req, _order, groups = pad_request_sorted(
        ladder, config.slots, kh0, ones, ones, ones,
        np.zeros(DEPTH, np.int32), np.zeros(DEPTH, bool), with_groups=True,
    )
    main_bkt = bucket_index(key_hash_tensor(groups.key_hash), config.slots).numpy()
    sweep_bkt = np.sort(np.random.default_rng(11).integers(0, 4096, DEPTH)).astype(np.int32)
    cases = [
        kernel_case("main path: 2^21 buckets, G of a zipf batch", config.slots, main_bkt, 1),
        kernel_case("sweep regime: 4096 buckets, B=32768", 4096, sweep_bkt, 2),
    ]
    for c in cases:
        emit(dict(phase="kernel", kernel="writeback_add", card=card, **c))

    # 3. main path: engine on the card ---------------------------------------
    eng = TorchEngine(config, buckets=ladder)
    t0 = time.monotonic()
    eng.warmup(now=T0)
    warm_s = time.monotonic() - t0
    writeback.writeback_add.launches = 0  # count the main path only
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
    hits = np.full(DEPTH, HITS, np.int64)
    limit = np.full(DEPTH, LIMIT, np.int64)
    duration = np.full(DEPTH, DURATION, np.int64)
    algo = np.zeros(DEPTH, np.int32)
    gnp = np.zeros(DEPTH, bool)
    batch_ms, groups_per_batch = [], []
    now = T0 + 10
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_batches):
        now += 2
        before = eng.stats.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.decide_wait(
            eng.decide_submit(pool[i], hits, limit, duration, algo, gnp, now)
        )
        dt = (time.perf_counter() - t0) * 1e3
        decides += 1
        after = eng.stats.snapshot()
        groups_per_batch.append(after["hits"] + after["misses"] - before["hits"] - before["misses"])
        status, rlimit, remaining, reset = out
        if not (
            status.shape == (DEPTH,) and np.isin(status, (0, 1)).all()
            and (rlimit == LIMIT).all() and (remaining >= 0).all()
            and (remaining <= LIMIT).all() and (reset > now).all()
        ):
            fail(f"batch {i}: responses out of range")
        if i < CHECKED_BATCHES:
            ref = cpu.decide_arrays(pool[i], hits, limit, duration, algo, gnp, now)
            for a, b, name in zip(out, ref, ("status", "limit", "remaining", "reset")):
                if not np.array_equal(a, b):
                    fail(f"batch {i}: {name} differs from the CPU run")
            if not torch.equal(eng.store.data.cpu(), cpu.store.data):
                fail(f"batch {i}: store bytes differ from the CPU run")
            emit(dict(phase="check", batch=i, cpu_identical=True))
        else:
            batch_ms.append(dt)
    launches = writeback.writeback_add.launches
    if launches != decides or launches == 0:
        fail(f"writeback kernel launched {launches} times for {decides} decides")
    total_s = sum(batch_ms) / 1e3
    p99 = float(np.percentile(batch_ms, 99))
    # the host presort + padding alone, on the same batches (numpy)
    prep_ms = []
    for i in range(CHECKED_BATCHES, min(n_batches, CHECKED_BATCHES + 10)):
        t0 = time.perf_counter()
        pad_request_sorted(ladder, config.slots, pool[i], hits, limit, duration,
                           algo, gnp, with_groups=True)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    emit(dict(
        phase="main", card=card, store_shape=list(eng.store.data.shape),
        store_bytes=eng.store.data.numel() * 4, batch=DEPTH,
        warmup_s=warm_s, timed_batches=len(batch_ms),
        decisions_per_s=len(batch_ms) * DEPTH / total_s,
        batch_ms_median=statistics.median(batch_ms), batch_ms_p99=p99,
        host_prep_ms_median=statistics.median(prep_ms),
        groups_per_batch_mean=float(np.mean(groups_per_batch)),
        decides=decides, kernel_launches=launches,
        stats=eng.stats.snapshot(),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    ))

    # 5. where a batch's time goes: torch.profiler over a few more batches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(PROFILED_BATCHES):
            now += 2
            eng.decide_arrays(pool[CHECKED_BATCHES + i], hits, limit, duration,
                              algo, gnp, now)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    wb_rows = [r for r in rows if "writeback_add_kernel" in r[0]]
    if not wb_rows:
        fail("torch.profiler saw no writeback kernel in the traced batches")
    if busy <= 0:
        fail("torch.profiler recorded no device time for the traced batches")
    emit(dict(phase="profile", card=card, batches=PROFILED_BATCHES, wall_us=wall_us,
              device_busy_us=busy, device_idle_share=1 - busy / wall_us,
              device_events_per_batch=sum(r[2] for r in rows) / PROFILED_BATCHES,
              writeback_device_us_per_call=wb_rows[0][1] / wb_rows[0][2],
              top=[dict(name=k[:80], device_us=d, count=c) for k, d, c in rows[:15]]))

    main_case = cases[0]
    emit({"kernels": [dict(
        name="writeback_add", route="cuda",
        source="gubernator_tpu_torch/csrc/writeback.cu",
        replaces="gubernator_tpu/core/pallas_sweep.py:97",
        launches=launches, max_abs_err=main_case["max_abs_err"],
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by="bytes",
        library_ms=main_case["library_ms"],
    )]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
