"""Serving-path benchmark suite: the reference's benchmark configs over a
real in-process cluster.

Reproduces the four benchmarks of reference benchmark_test.go against
localhost gRPC — the apples-to-apples serving numbers (the device-kernel
throughput number lives in bench.py):

  no_batching      BenchmarkServer_GetPeerRateLimitNoBatching (:27-53) —
                   direct PeersV1/GetPeerRateLimits unary calls
  get_rate_limit   BenchmarkServer_GetRateLimit (:55-79) — single-item
                   V1/GetRateLimits
  ping             BenchmarkServer_Ping (:81-98) — V1/HealthCheck
  thundering_herd  BenchmarkServer_ThunderingHeard [sic] (:109-137) —
                   100 concurrent workers issuing GetRateLimits
  batched          no reference analogue: one 1000-item GetRateLimits per
                   call, the shape production batching actually sends
                   (reference README.md:111-117 observes ~1000-item peaks)

and the serving scenarios (zipf10m, zipf100m, key-churn, shed,
flash-crowd, mixed-tenant-zipf, gcra-vs-token) through the serving stack
booted as the daemon boots it.

Usage: python -m gubernator_tpu_torch.cli.bench_serving [--backend tpu|mesh|exact]
       [--device cuda|cpu] [--seconds N] [--json]

The port of gubernator_tpu/cli/bench_serving.py: the same scenarios,
store sizes, depths, groups, limits, key spaces and seeds, and JSON rows
with the same keys, on the port's stack. The device is explicit: every
device scenario runs on `--device` (cuda unless the caller passes cpu),
and without a GPU a cuda run fails with the engine's message
(core.store.resolve_device); it never carries on on the CPU. The `scope`
and `device` fields name the card (torch.cuda.get_device_name). The
port compiles nothing per rung, so there is no compile cache. Every
call of the cluster suite carries a deadline (`CALL_TIMEOUT_S`, the HTTP
calls' 10 s; the reference's gRPC calls have none), so a wedged door
shows as counted errors instead of a hung run. The `shard` scenario
runs its rungs in this process, each rung's shards laid over the local
devices in turn (the reference spawns one process a rung to size its
simulated XLA devices), and `--backend mesh` shards each node over the
local devices.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Callable, List

import grpc

from gubernator_tpu_torch.api.grpc_glue import PeersV1Stub, V1Stub
from gubernator_tpu_torch.api.proto.gen import gubernator_pb2, peers_pb2
from gubernator_tpu_torch.cluster import LocalCluster

ADDRESSES = [f"127.0.0.1:{p}" for p in range(9980, 9986)]
PYTHON_HTTP_ADDR = "127.0.0.1:19978"  # node 0's gateway under --edge
EDGE_PORT = 19979  # the edge's HTTP JSON door under --edge
EDGE_GRPC_PORT = 19981  # the edge's gRPC door under --edge
#: the suite's per-call deadline, gRPC and HTTP alike: a wedged door
#: shows as counted errors instead of a worker hung past its window
CALL_TIMEOUT_S = 10

def _dev(device: str):
    """The engine's `device` argument for a --device name: None for cuda,
    so that a host with no GPU fails with the engine's own message
    (core.store.resolve_device) instead of carrying on on the CPU."""
    return None if device == "cuda" else device


def _device_info(device: str) -> dict:
    """platform / kind / count of the device a scenario ran on: the JSON
    rows' `scope` and `device` (the reference reads jax.devices())."""
    import torch

    if device == "cuda":
        return dict(
            platform="gpu",
            kind=torch.cuda.get_device_name(0),
            count=torch.cuda.device_count(),
        )
    return dict(platform="cpu", kind="cpu", count=1)


def _front_door_call(url: str, body: bytes):
    """One HTTP POST closure per front door (python gateway / C++ edge)."""
    import urllib.request

    def call(i: int):
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        urllib.request.urlopen(req, timeout=CALL_TIMEOUT_S).read()

    return call


def _req(key: str) -> gubernator_pb2.RateLimitReq:
    return gubernator_pb2.RateLimitReq(
        name="get_rate_limit_benchmark",
        unique_key=key,
        hits=1,
        limit=1_000_000,
        duration=10_000,
        algorithm=gubernator_pb2.TOKEN_BUCKET,
    )


def _measure(
    name: str,
    call: Callable[[int], None],
    seconds: float,
    workers: int = 1,
) -> dict:
    """Run `call(i)` as fast as possible for `seconds` on N workers,
    recording per-call latency (p50/p99/p99.9 — BASELINE config 3's
    target is p99 < 1ms under GLOBAL). Latency is sampled every
    LAT_SAMPLE-th call into a compact double array so instrumentation
    can't perturb the ops/s headline or grow unbounded on long runs."""
    from array import array

    LAT_SAMPLE = 8
    stop = time.monotonic() + seconds
    counts = [0] * workers
    errors = [0] * workers
    lats = [array("d") for _ in range(workers)]

    def run(w: int):
        i = 0
        append = lats[w].append
        while time.monotonic() < stop:
            sampled = counts[w] % LAT_SAMPLE == 0
            t0 = time.monotonic() if sampled else 0.0
            try:
                call(w * 1_000_000 + i)
                if sampled:
                    append(time.monotonic() - t0)
                counts[w] += 1
            except (grpc.RpcError, OSError):
                # OSError covers urllib/socket failures on the edge path
                errors[w] += 1
            i += 1

    threads = [
        threading.Thread(target=run, args=(w,), daemon=True)
        for w in range(workers)
    ]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    n = sum(counts)
    res = {
        "name": name,
        "ops": n,
        "errors": sum(errors),
        "seconds": round(elapsed, 3),
        "ops_per_sec": round(n / elapsed, 1),
        "workers": workers,
    }
    all_lat = sorted(v for per_w in lats for v in per_w)
    if all_lat:
        def pct(p: float) -> float:
            idx = min(len(all_lat) - 1, int(p * (len(all_lat) - 1)))
            return round(all_lat[idx] * 1e3, 3)

        res["p50_ms"] = pct(0.50)
        res["p99_ms"] = pct(0.99)
        res["p999_ms"] = pct(0.999)
    print(
        f"{name:18s} {res['ops_per_sec']:12,.0f} ops/s   "
        f"({n} ops, {workers} workers, {elapsed:.1f}s)  "
        f"p50={res.get('p50_ms', '-')}ms p99={res.get('p99_ms', '-')}ms "
        f"p99.9={res.get('p999_ms', '-')}ms",
        file=sys.stderr,
    )
    return res


async def _attach_edge_bridge(server, sock_path):
    from gubernator_tpu_torch.serve.edge_bridge import EdgeBridge

    bridge = EdgeBridge(server.instance, sock_path)
    await bridge.start()
    return bridge


async def _boot_stack(conf, metric, depth, device="cuda", devices=None):
    """Boot the SHIPPED stack (make_backend -> warmup -> Instance) on
    `device` (a mesh on `devices` when given); returns (instance,
    backend, warmup_seconds)."""
    import asyncio

    from gubernator_tpu_torch.serve.backends import make_backend
    from gubernator_tpu_torch.serve.instance import Instance

    backend = make_backend(conf, device=_dev(device), devices=devices)
    print(f"{metric} depth {depth}: warmup (every ladder rung once)...",
          file=sys.stderr)
    t0 = time.monotonic()
    await asyncio.to_thread(backend.warmup)
    warm_s = time.monotonic() - t0
    inst = Instance(conf, backend)
    inst.start()
    return inst, backend, warm_s


async def _prefill_sequential(inst, n_ids, group, limit, duration):
    """Saturate the exact tier: drive `n_ids` SEQUENTIAL ids (same
    params as the measured traffic) so the measured window runs at the
    steady state the scenario is about — tier pressure, not a cold
    store. The zipf head's small ids overlap these, so hot keys decide
    exactly while the tail fights for ways."""
    import asyncio

    import numpy as np

    from gubernator_tpu_torch.cli import keystreams

    n_chunks = -(-n_ids // group)

    async def filler(w: int, W: int):
        ones = np.ones(group, np.int64)
        algo = np.zeros(group, np.int32)
        for c in range(w, n_chunks, W):
            ids = np.arange(
                c * group, (c + 1) * group, dtype=np.uint64
            )
            await inst.batcher.decide_arrays(
                dict(
                    key_hash=keystreams.hash_ids(ids), hits=ones,
                    limit=ones * limit, duration=ones * duration,
                    algo=algo,
                )
            )

    t0 = time.monotonic()
    await asyncio.gather(*[filler(w, 8) for w in range(8)])
    print(
        f"prefill: {n_ids:,} sequential ids in "
        f"{time.monotonic() - t0:.0f}s", file=sys.stderr,
    )


async def _measure_window(
    inst, backend, pool, depth, seconds, group, metric, limit=1000,
    duration=60_000, churn=False, key_space=1 << 40, algo_id=0,
) -> dict:
    """One timed window of pre-hashed key traffic through the
    batcher's array door — the zipf10m/zipf100m/key-churn scenarios'
    one measurement loop. `churn=True` advances the whole pool by a
    fresh phase every pass (keystreams.churn_pool) so no key is ever
    hot twice. `algo_id` drives the stream under a non-token algorithm
    (the r21 zipf100m sliding/GCRA arms)."""
    import asyncio

    import numpy as np

    from gubernator_tpu_torch.cli import keystreams

    stop_at = time.monotonic() + seconds
    done_rows = 0
    base = backend.stats()

    async def worker(w: int):
        nonlocal done_rows
        i = w * 101
        ones = np.ones(group, np.int64)
        algo = np.full(group, algo_id, np.int32)
        passes = 0
        while time.monotonic() < stop_at:
            if churn:
                # every pass is a FRESH key set: the adversarial
                # tier-thrash stream (ROADMAP item 4). One GROUP-sized
                # pool per pass (worker-disjoint phase stride), not a
                # full staging pool — regenerating 2^18 hashed ids per
                # submitted group was measured event-loop cost, not
                # system-under-test cost
                passes += 1
                kh = keystreams.churn_pool(
                    key_space, group, passes * workers + w
                )
            else:
                off = (i * group) % (pool.shape[0] - group)
                i += 1
                kh = pool[off : off + group]
            fields = dict(
                key_hash=kh,
                hits=ones,
                limit=ones * limit,
                duration=ones * duration,
                algo=algo,
            )
            await inst.batcher.decide_arrays(fields)
            done_rows += group

    # enough concurrent groups outstanding to keep the submit
    # gate saturated (deep accumulation engages only then):
    # ~2 full deep batches of groups, floor 8
    workers = max(8, 2 * depth // group)
    t0 = time.monotonic()
    await asyncio.gather(*[worker(w) for w in range(workers)])
    elapsed = time.monotonic() - t0
    end = backend.stats()
    batches = end["batches"] - base["batches"]
    row = dict(
        metric=metric,
        depth=depth,
        decisions_per_sec=round(done_rows / elapsed, 1),
        mean_device_batch=(
            round(done_rows / batches, 1) if batches else 0.0
        ),
        device_batches=batches,
        seconds=round(elapsed, 3),
        workers=workers,
        group_rows=group,
        # exact-tier pressure: with the sketch tier on, dropped
        # creates ARE the sketch-served group count (fail-closed);
        # with it off they are silent over-admission
        dropped_creates=end["dropped"] - base["dropped"],
        evictions=end["evictions"] - base["evictions"],
    )
    if inst.promoter is not None:
        row["promoter"] = inst.promoter.stats()
    return row


async def _drive_pool(
    conf, pool, depth, seconds, group, metric, limit=1000,
    duration=60_000, churn=False, key_space=1 << 40, prefill_ids=0,
    device="cuda", devices=None,
) -> dict:
    """_boot_stack + optional _prefill_sequential + one
    _measure_window + stop — the single-phase scenario runner."""
    # a caller group can never exceed the ladder top (the batcher
    # ships an oversized group alone and choose_bucket would refuse)
    group = min(group, depth)
    inst, backend, warm_s = await _boot_stack(conf, metric, depth, device, devices)
    try:
        if prefill_ids:
            await _prefill_sequential(
                inst, prefill_ids, group, limit, duration
            )
        row = await _measure_window(
            inst, backend, pool, depth, seconds, group, metric,
            limit, duration, churn, key_space,
        )
        row["warmup_seconds"] = round(warm_s, 1)
        return row
    finally:
        await inst.stop()


def run_zipf10m(args) -> int:
    """BASELINE config 4 through the SHIPPED serving configuration.

    Each depth row boots the serving stack exactly as the daemon does —
    GUBER_* env knobs -> config_from_env (validation included) ->
    make_backend (store sized by GUBER_STORE_MIB/GUBER_STORE_TARGET_KEYS,
    ladder from GUBER_DEVICE_BATCH_LIMIT) -> warmup (every rung runs
    once here, before traffic) -> Instance + DeviceBatcher with
    GUBER_DEVICE_DEEP_BATCH accumulation — then drives zipfian traffic
    through the batcher's array door (`decide_arrays`, the same entry the
    edge bridge's pre-hashed GEB6 frames use) from concurrent callers
    whose groups the deep-batch collector coalesces to the rung. The
    emitted rows demonstrate the measured big-store law on the shipped
    path: at FIXED store footprint, throughput scales with batch depth
    because the writeback's full-table pass is paid once per batch
    (docs/round5.md; BENCH_ZIPF10M_PROFILE_r5.json).

    Scoping: on the card this is config 4 itself (1 GiB store, 10M
    keys); with --device cpu pass a scaled --store-mib/--keys and the
    artifact records scope="cpu" — the depth-scaling shape, not the
    absolute numbers, is the claim.
    """
    import asyncio
    import os

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.serve.config import config_from_env

    depths = [int(d) for d in args.depths.split(",") if d.strip()]
    # the one shared zipf key recipe (cli/keystreams.py) over args.keys;
    # pre-hashed like edge GEB6 frames, staged outside the timed region
    pool = keystreams.zipf_pool(args.keys, 1 << 22)
    rows = []

    async def run_depth(conf, depth) -> dict:
        return await _drive_pool(
            conf, pool, depth, args.seconds, args.group,
            "zipf10m_serving_mode", device=args.device,
        )

    for depth in depths:
        env = dict(os.environ)
        env.update(
            {
                "GUBER_BACKEND": args.backend,
                "GUBER_DEVICE_BATCH_LIMIT": str(depth),
                "GUBER_DEVICE_DEEP_BATCH": "1",
                "GUBER_STORE_MIB": str(args.store_mib),
                "GUBER_STORE_TARGET_KEYS": str(args.keys),
                "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
            }
        )
        env.pop("GUBER_STORE_SLOTS", None)
        # the historical exact-only scenario: the whole MiB budget goes
        # to the exact tier (the r13 sketch sibling is --scenario
        # zipf100m); an explicit GUBER_SKETCH in the environment wins
        env.setdefault("GUBER_SKETCH", "0")
        conf = config_from_env(env)  # the shipped knob surface, validated
        r = asyncio.run(run_depth(conf, depth))
        print(
            f"depth {depth:>7}: {r['decisions_per_sec']:>14,.0f} dec/s  "
            f"(mean device batch {r['mean_device_batch']:,.0f}, "
            f"{r['device_batches']} batches)",
            file=sys.stderr,
        )
        rows.append(r)

    info = _device_info(args.device)
    doc = dict(
        scenario="zipf10m_throughput_serving_mode",
        scope=info["platform"],
        device=info["kind"],
        backend=args.backend,
        store_mib=args.store_mib,
        key_space=args.keys,
        served_via=(
            "config_from_env -> make_backend -> Instance/DeviceBatcher"
            " (GUBER_DEVICE_DEEP_BATCH=1), array door"
        ),
        env_knobs={
            "GUBER_BACKEND": args.backend,
            "GUBER_DEVICE_DEEP_BATCH": "1",
            "GUBER_STORE_MIB": str(args.store_mib),
            "GUBER_STORE_TARGET_KEYS": str(args.keys),
            "GUBER_DEVICE_BATCH_LIMIT": "<row depth>",
            "GUBER_PREP_THREADS": os.environ.get(
                "GUBER_PREP_THREADS", "<default>"
            ),
            "GUBER_PREP_AT_ARRIVAL": os.environ.get(
                "GUBER_PREP_AT_ARRIVAL", "1"
            ),
        },
        notes=(
            "depth rows share one fixed store footprint; throughput "
            "scaling with depth is the big-store writeback-amortization "
            "law on the shipped serving path (docs/round5.md, "
            "BENCH_ZIPF10M_PROFILE_r5.json)."
        ),
        rows=rows,
    )
    if args.json:
        print(json.dumps(doc))
    return 0


def shard_devices(n: int, device: str) -> list:
    """n shards over the local devices of `device`'s kind, in turn: on a
    machine with one GPU (or on the CPU) every shard shares it."""
    from gubernator_tpu_torch.parallel.policy import local_devices

    avail = local_devices(_dev(device))
    return [avail[i % len(avail)] for i in range(n)]


def run_shard(args) -> int:
    """Shard-count ladder: the same serving stack under the flat policy
    (1 shard, GUBER_BACKEND=tpu) and the mesh policy at each --shards
    rung (GUBER_BACKEND=mesh, the rung's shards laid over the local
    devices in turn), one zipf window each through the batcher's array
    door. The reference runs each rung on that many SIMULATED host
    devices sharing one CPU; here each rung's shards share the devices
    there are, so on one GPU (or the CPU) the rows measure the mesh's
    host routing and per-shard dispatch, not chip scaling: that needs a
    card a shard. The per-shard table geometry is the same on every
    rung."""
    import asyncio
    import os

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.serve.config import config_from_env

    ladder = [int(x) for x in args.shards.split(",") if x.strip()]
    pool = keystreams.zipf_pool(args.keys, 1 << 18)
    rows = []
    for policy, n in [("flat", 1)] + [("mesh", n) for n in ladder]:
        env = dict(os.environ)
        env.update(
            {
                "GUBER_BACKEND": "tpu" if policy == "flat" else "mesh",
                "GUBER_DEVICE_BATCH_LIMIT": str(args.shard_depth),
                "GUBER_STORE_SLOTS": str(args.shard_slots),
                "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
            }
        )
        for k in ("GUBER_STORE_MIB", "GUBER_STORE_TARGET_KEYS", "GUBER_SHARDS"):
            env.pop(k, None)
        if policy == "mesh":
            env["GUBER_SHARDS"] = str(n)
        conf = config_from_env(env)
        devices = shard_devices(n, args.device) if policy == "mesh" else None
        print(f"shard ladder: {policy} x{n}...", file=sys.stderr)
        row = asyncio.run(_drive_pool(
            conf, pool, conf.device_batch_limit, args.seconds, args.group,
            f"shard_{policy}_{n}", device=args.device, devices=devices,
        ))
        row["shards"] = n
        row["policy"] = policy
        row["shard_devices"] = [str(d) for d in devices] if devices else [args.device]
        print(
            f"  {policy} x{n}: {row['decisions_per_sec']:>12,.0f} dec/s"
            f"  (mean device batch {row['mean_device_batch']:,.0f})",
            file=sys.stderr,
        )
        rows.append(row)

    flat_rate = rows[0]["decisions_per_sec"]
    for r in rows:
        r["vs_flat"] = round(r["decisions_per_sec"] / flat_rate, 4) if flat_rate else 0.0
    info = _device_info(args.device)
    doc = dict(
        scenario="shard_ladder_r14",
        scope=info["platform"],
        device=info["kind"],
        n_devices=info["count"],
        host_cpus=os.cpu_count(),
        shards_ladder=ladder,
        served_via=(
            "config_from_env -> make_backend (GUBER_BACKEND=tpu|mesh, "
            "GUBER_SHARDS, the shard list over the local devices) -> "
            "Instance/DeviceBatcher array door"
        ),
        env_knobs={
            "GUBER_DEVICE_BATCH_LIMIT": str(args.shard_depth),
            "GUBER_STORE_SLOTS": str(args.shard_slots),
            "GUBER_SHARDS": "<row shards>",
        },
        key_space=args.keys,
        notes=(
            "Each rung's shards share the local devices in turn (one GPU "
            "or the CPU holds every shard), so rows measure the mesh's "
            "host owner-routing and per-shard dispatch against the flat "
            "policy, not chip scaling: each shard needs a card of its own "
            "for that. Per-shard sub-batches hold ~B/n rows "
            "(tests/test_torch_sharded.py pins the sub-batch economy)."
        ),
        rows=rows,
    )
    if args.json:
        print(json.dumps(doc))
    return 0


def _filler_hashes(slots: int) -> "np.ndarray":
    """One uint64 key hash per store bucket (error-measurement rig):
    with every bucket's ways held by LIVE entries that are ALSO present
    in each batch (found-writers), a rank-0 miss can never evict — so
    every measured key provably decides on the sketch tier."""
    import numpy as np

    from gubernator_tpu_torch.core.store import group_sort_key_np

    out = {}
    rng = np.random.default_rng(123)
    while len(out) < slots:
        cand = rng.integers(1, 2**63, 1024).astype(np.uint64)
        bkt = (group_sort_key_np(cand, slots) >> np.uint64(32)).astype(
            np.int64
        )
        for h, b in zip(cand.tolist(), bkt.tolist()):
            out.setdefault(int(b), h)
    return np.array([out[b] for b in range(slots)], np.uint64)


def measure_tail_error(
    batches: int = 96, sketch_mib: int = 8, seed: int = 7,
    derivation: str = "v2", algorithm: str = "token", rows: int = 0,
    device: str = "cuda",
) -> dict:
    """Measured tail-key error of the sketch tier on a pinned zipf
    stream (the r13 acceptance phase, derivation- and algorithm-aware
    since r21; also driven by the property test in
    tests/test_sketch_tier.py).

    Rig: a tiny exact store whose buckets are pinned full of immortal
    filler entries included in every batch, so EVERY measured key's
    create drops and decides from the sketch — the clean measurement of
    sketch error, uncontaminated by exact-tier wins. Limits are huge so
    every hit admits and charges regardless of `algorithm` (the
    window-ring serves sliding/GCRA through the same per-window cells),
    making host-side tallies the exact ground truth for the counts the
    sketch was charged with. Reports max/mean overestimate against the
    documented classic-CM bound e*N/width (conservative update only
    tightens it) and the under-count count, which must be ZERO
    (one-sided error = fail-closed). `derivation` selects the counter
    geometry at the SAME byte budget: "v2" (2 rows of saturating int32,
    4x the width of r13 -> 4x tighter bound per byte) or "r13" (4 rows
    of int64, the committed r13 geometry). The engine lives on `device`;
    the store is integer state, so every device gives the same dict."""
    import math

    import numpy as np

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.core.algorithms import ALGO_NAMES
    from gubernator_tpu_torch.core.sketches import derive_sketch_config
    from gubernator_tpu_torch.core.store import StoreConfig
    from gubernator_tpu_torch.parallel.sharded import TorchEngine

    cfg = StoreConfig(rows=1, slots=64)
    skc = derive_sketch_config(
        mib=sketch_mib, rows=rows, derivation=derivation
    )
    eng = TorchEngine(cfg, buckets=(4096,), sketch=skc, device=_dev(device))
    T0 = 1_700_000_000_000
    fill = _filler_hashes(cfg.slots)
    nf = fill.shape[0]
    B = 4096
    DUR, LIM = 600_000, 1 << 30
    onesf = np.ones(nf, np.int64)
    # create the immortal fillers (limit/duration arbitrary, just live)
    eng.decide_arrays(
        fill, onesf, onesf * 1000, onesf * 1_000_000_000,
        np.zeros(nf, np.int32), np.zeros(nf, bool), T0,
    )
    nm = B - nf
    hits = np.concatenate([np.zeros(nf, np.int64), np.ones(nm, np.int64)])
    limit = np.full(B, LIM, np.int64)
    dur = np.full(B, DUR, np.int64)
    algo = np.full(B, ALGO_NAMES[algorithm], np.int32)
    algo[:nf] = 0
    gnp = np.zeros(B, bool)
    rng = np.random.default_rng(seed)
    true = np.zeros(10_000, np.int64)
    for b in range(batches):
        ids = keystreams.zipf_ids(10_000, nm, rng)
        kh = np.concatenate([fill, keystreams.hash_ids(ids)])
        eng.decide_arrays(kh, hits, limit, dur, algo, gnp, T0 + b)
        np.add.at(true, ids, 1)
    touched = np.flatnonzero(true)
    est = eng.sketch_estimates(
        keystreams.hash_ids(touched), np.full(touched.shape[0], DUR),
        T0 + batches + 1,
    )
    diff = est - true[touched]
    n_charged = int(true.sum())
    bound = math.e * n_charged / skc.width
    return dict(
        metric="sketch_tail_error",
        algorithm=algorithm,
        derivation=derivation,
        distinct_keys=int(touched.shape[0]),
        charged_hits=n_charged,
        sketch_rows=skc.rows,
        sketch_width=skc.width,
        counter_bytes=skc.counter_bytes,
        under_counts=int((diff < 0).sum()),
        max_overestimate=int(diff.max()),
        mean_overestimate=round(float(diff.mean()), 4),
        documented_bound=round(bound, 2),
        bound_formula="e * charged_hits / width (classic CM; "
        "conservative update only tightens it)",
        within_bound=bool(diff.max() <= bound),
        batches=batches,
        seed=seed,
    )


def measure_tail_error_ab(
    batches: int = 96, sketch_mib: int = 8, seed: int = 7,
    device: str = "cuda",
) -> dict:
    """The r21 derivation A/B at ONE byte budget: the committed r13
    geometry vs the v2 additive-error geometry on the identical pinned
    stream. The acceptance claim is strict: v2's measured max
    overestimate must sit BELOW r13's theoretical bound (and v2's own
    bound is 4x tighter), with zero under-counts on both sides."""
    r13 = measure_tail_error(
        batches=batches, sketch_mib=sketch_mib, seed=seed,
        derivation="r13", device=device,
    )
    v2 = measure_tail_error(
        batches=batches, sketch_mib=sketch_mib, seed=seed,
        derivation="v2", device=device,
    )
    return dict(
        metric="sketch_tail_error_derivation_ab",
        sketch_mib=sketch_mib,
        r13=r13,
        v2=v2,
        v2_bound_over_r13_bound=round(
            v2["documented_bound"] / r13["documented_bound"], 4
        ),
        v2_max_below_r13_bound=bool(
            v2["max_overestimate"] < r13["documented_bound"]
        ),
        zero_under_counts=bool(
            v2["under_counts"] == 0 and r13["under_counts"] == 0
        ),
    )


def run_zipf100m(args) -> int:
    """The r13 sketch-tier flagship: ~100M-key cardinality at the SAME
    fixed device budget the exact-only zipf10m scenario uses. Since r21
    the tail-error phase runs the r13-vs-v2 derivation A/B plus sliding
    and GCRA arms (window-ring serving), and two algorithm arm rows
    drive the 100M-key stream under sliding/GCRA on the sketch stack.

    Three phases, one artifact (BENCH_SKETCH_r21.json; r13 shape was
    BENCH_SKETCH_r13.json):

    1. `zipf10m_exact_baseline` — the r6 flagship shape: the whole
       GUBER_STORE_MIB budget as one exact tier, 10M-key zipf. This is
       the in-run baseline the acceptance compares against (same box,
       same minutes — box-speed cancels in the ratio).
    2. `zipf100m_sketch_tier` — GUBER_SKETCH=1 at the SAME total
       budget: the sketch's footprint is carved out of the budget
       (exact tier shrinks to fit), and the zipf stream spans
       args.keys (default 100M) ids — 10x the exact tier's entry
       count, impossible for the exact-only geometry. Dropped creates
       (= sketch-served decisions) and promoter stats are recorded.
    3. `sketch_tail_error` — the measured one-sided error bound on a
       pinned stream (measure_tail_error): zero under-counts, max
       overestimate within e*N/width.
    """
    import asyncio
    import os

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.serve.config import config_from_env

    depth = int(args.depths.split(",")[0])

    def conf_for(sketch: bool, keys: int):
        env = dict(os.environ)
        env.update(
            {
                "GUBER_BACKEND": "tpu",
                "GUBER_DEVICE_BATCH_LIMIT": str(depth),
                "GUBER_DEVICE_DEEP_BATCH": "1",
                "GUBER_STORE_MIB": str(args.store_mib),
                "GUBER_STORE_TARGET_KEYS": str(keys),
                "GUBER_SKETCH": "1" if sketch else "0",
                "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
            }
        )
        env.pop("GUBER_STORE_SLOTS", None)
        return config_from_env(env)

    import statistics

    conf_a = conf_for(False, 10_000_000)
    conf_b = conf_for(True, args.keys)
    pool10 = keystreams.zipf_pool(10_000_000, 1 << 22)
    pool100 = keystreams.zipf_pool(args.keys, 1 << 22)
    DUR = 600_000
    group = min(args.group, depth)
    rounds = max(2, getattr(args, "rounds", 3))

    async def run_paired():
        """Both stacks resident, INTERLEAVED alternating-order windows
        (the r9 methodology): a shared host's ambient throttling can
        drift 2x on minute scales, so adjacent-phase comparisons are
        noise — per-round paired ratios are the robust statistic."""
        a_inst, a_be, a_warm = await _boot_stack(
            conf_a, "zipf10m_exact_baseline", depth, args.device
        )
        b_inst, b_be, b_warm = await _boot_stack(
            conf_b, "zipf100m_sketch_tier", depth, args.device
        )
        try:
            # phase B runs at the steady state the scenario is about:
            # the exact tier saturated (1.25x its entry capacity of
            # sequential ids; the zipf HEAD overlaps them, so hot keys
            # decide exactly while the tail fights for ways)
            from gubernator_tpu_torch.core.store import store_capacity

            await _prefill_sequential(
                b_inst,
                int(store_capacity(conf_b.store_config()) * 1.25),
                group, 1000, DUR,
            )
            a_rows, b_rows, pairs = [], [], []
            for rnd in range(rounds):
                order = (
                    [("a", a_inst, a_be, pool10,
                      "zipf10m_exact_baseline"),
                     ("b", b_inst, b_be, pool100,
                      "zipf100m_sketch_tier")]
                )
                if rnd % 2:
                    order.reverse()
                rates = {}
                for which, inst, be, pool, metric in order:
                    r = await _measure_window(
                        inst, be, pool, depth, args.seconds, group,
                        metric, 1000, DUR,
                    )
                    rates[which] = r
                    (a_rows if which == "a" else b_rows).append(r)
                ratio = (
                    rates["b"]["decisions_per_sec"]
                    / rates["a"]["decisions_per_sec"]
                )
                pairs.append(round(ratio, 4))
                print(
                    f"round {rnd}: exact "
                    f"{rates['a']['decisions_per_sec']:>11,.0f} "
                    f"sketch "
                    f"{rates['b']['decisions_per_sec']:>11,.0f} dec/s"
                    f"  ratio {ratio:.3f}  (dropped->sketch "
                    f"{rates['b']['dropped_creates']}, evictions "
                    f"{rates['b']['evictions']})",
                    file=sys.stderr,
                )

            def agg(rws, metric, warm):
                med = statistics.median(
                    r["decisions_per_sec"] for r in rws
                )
                return dict(
                    metric=metric,
                    depth=depth,
                    decisions_per_sec=med,
                    rounds=[r["decisions_per_sec"] for r in rws],
                    warmup_seconds=round(warm, 1),
                    workers=rws[0]["workers"],
                    group_rows=group,
                    dropped_creates=sum(
                        r["dropped_creates"] for r in rws
                    ),
                    evictions=sum(r["evictions"] for r in rws),
                    **(
                        {"promoter": rws[-1]["promoter"]}
                        if "promoter" in rws[-1]
                        else {}
                    ),
                )

            # r21 algorithm arms: the SAME 100M-key stream under
            # sliding and GCRA on the resident sketch stack — the
            # window-ring must keep serving the saturation tier's
            # dropped creates (dropped_creates > 0) when operators
            # pick the fairness algorithms, not just token
            from gubernator_tpu_torch.core.algorithms import ALGO_NAMES

            arm_rows = []
            for arm in ("sliding", "gcra"):
                r = await _measure_window(
                    b_inst, b_be, pool100, depth, args.seconds, group,
                    f"zipf100m_sketch_{arm}", 1000, DUR,
                    algo_id=ALGO_NAMES[arm],
                )
                r["algorithm"] = arm
                arm_rows.append(r)
                print(
                    f"arm {arm}: "
                    f"{r['decisions_per_sec']:>11,.0f} dec/s "
                    f"(dropped->sketch {r['dropped_creates']})",
                    file=sys.stderr,
                )

            return (
                agg(a_rows, "zipf10m_exact_baseline", a_warm),
                agg(b_rows, "zipf100m_sketch_tier", b_warm),
                pairs,
                arm_rows,
            )
        finally:
            await b_inst.stop()
            await a_inst.stop()

    row_a, row_b, pairs, arm_rows = asyncio.run(run_paired())
    rows = [row_a, row_b] + arm_rows
    paired_ratio = statistics.median(pairs)
    for r in rows:
        print(
            f"{r['metric']:24s} {r['decisions_per_sec']:>14,.0f} dec/s "
            f"(median; dropped->sketch {r['dropped_creates']}, "
            f"evictions {r['evictions']})",
            file=sys.stderr,
        )
    print(
        "measuring tail error (pinned stream, r13-vs-v2 A/B)...",
        file=sys.stderr,
    )
    err_ab = measure_tail_error_ab(device=args.device)
    err = err_ab["v2"]
    print(
        f"tail error v2: max over {err['max_overestimate']} "
        f"(v2 bound {err['documented_bound']}, r13 bound "
        f"{err_ab['r13']['documented_bound']}), under-counts "
        f"{err['under_counts']}",
        file=sys.stderr,
    )
    err_arms = {}
    for arm in ("sliding", "gcra"):
        e = measure_tail_error(algorithm=arm, device=args.device)
        err_arms[arm] = e
        print(
            f"tail error {arm}: max over {e['max_overestimate']} "
            f"(bound {e['documented_bound']}), under-counts "
            f"{e['under_counts']}",
            file=sys.stderr,
        )

    info = _device_info(args.device)
    doc = dict(
        scenario="zipf100m_sketch_tier",
        scope=info["platform"],
        device=info["kind"],
        store_mib=args.store_mib,
        key_space=args.keys,
        depth=depth,
        served_via=(
            "config_from_env -> make_backend (sketch carve-out) -> "
            "Instance/DeviceBatcher (deep batch), array door; BOTH "
            "stacks resident, interleaved alternating-order windows "
            "(r9 methodology) — the paired per-round ratio is the "
            "drift-robust headline"
        ),
        paired_ratios=pairs,
        env_knobs={
            "GUBER_STORE_MIB": str(args.store_mib),
            "GUBER_SKETCH": "1 (phase 2) / 0 (phase 1)",
            "GUBER_SKETCH_MIB": os.environ.get(
                "GUBER_SKETCH_MIB", "0 (auto: store_mib/4, cap 256)"
            ),
            "GUBER_DEVICE_BATCH_LIMIT": str(depth),
            "GUBER_DEVICE_DEEP_BATCH": "1",
        },
        rows=rows,
        tail_error=err,
        tail_error_derivation_ab=err_ab,
        tail_error_arms=err_arms,
        sketch_over_exact_baseline=round(paired_ratio, 4),
        acceptance=dict(
            target="zipf100m at the fixed total budget sustains >= the "
            "zipf10m exact-only baseline, tail error within bound, "
            "zero under-counts; r21: v2 max overestimate strictly "
            "below the r13 bound at the same budget, sliding+GCRA "
            "arms sketch-served at 100M-key cardinality",
            throughput_met=bool(paired_ratio >= 1.0),
            error_met=bool(
                err["within_bound"] and err["under_counts"] == 0
            ),
            derivation_met=bool(
                err_ab["v2_max_below_r13_bound"]
                and err_ab["zero_under_counts"]
            ),
            arms_met=bool(
                all(
                    e["within_bound"] and e["under_counts"] == 0
                    for e in err_arms.values()
                )
                and all(r["dropped_creates"] > 0 for r in arm_rows)
            ),
        ),
        acceptance_note=(
            None
            if paired_ratio >= 1.0
            else (
                "the >= target leans on the footprint law (the sketch "
                "phase's exact tier is HALF the baseline's footprint); "
                "where the batch's host work, not the store pass, "
                "bounds the rate, the 100M-key stream's near-unique "
                "batches carry more unique-key groups than the 10M "
                "baseline's. The CARDINALITY claim stands as measured: "
                "10x the key space at the same fixed budget with "
                "bounded fail-closed tail error, zero under-counts, "
                "and saturation-tier traffic actually served — vs "
                "silent over-admission at this pressure exact-only."
            )
        ),
        notes=(
            "the sketch phase's exact tier is the budget minus the "
            "sketch carve-out (config.store_config), so both phases "
            "fit the SAME total device budget (power-of-two floors "
            "mean the two-tier phase provisions 512 MiB exact + "
            "256 MiB sketch of the 1024); its exact tier is PREFILLED "
            "to 1.25x capacity before the rounds so the windows "
            "measure tier-pressure steady state. dropped_creates in "
            "the sketch phase are sketch-served fail-closed "
            "decisions; in the baseline they are silent "
            "over-admission."
        ),
    )
    if args.json:
        print(json.dumps(doc))
    return 0


def run_churn(args) -> int:
    """Adversarial key-churn scenario (ROADMAP item 4): every pass is
    an entirely fresh key set (cli/keystreams.py churn_pool), defeating
    the shed cache, the exact tier's residency, and the promoter's
    top-K by construction — the worst case for tier thrash. The row
    pins that the stack survives it at full load: bounded promoter
    memory, no error, dropped creates absorbed by the sketch tier."""
    import asyncio
    import os

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.serve.config import config_from_env

    depth = int(args.depths.split(",")[0])
    env = dict(os.environ)
    env.update(
        {
            "GUBER_BACKEND": "tpu",
            "GUBER_DEVICE_BATCH_LIMIT": str(depth),
            "GUBER_DEVICE_DEEP_BATCH": "1",
            "GUBER_STORE_MIB": str(args.store_mib),
            "GUBER_STORE_TARGET_KEYS": str(args.keys),
            "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
        }
    )
    env.pop("GUBER_STORE_SLOTS", None)
    conf = config_from_env(env)
    # the churn path generates its key stream per pass inside the
    # measurement loop; this pool only satisfies the non-churn
    # signature and is never indexed
    group = min(args.group, depth)
    pool = keystreams.churn_pool(args.keys, 2 * group, 0)
    r = asyncio.run(
        _drive_pool(
            conf, pool, depth, args.seconds, args.group, "key_churn",
            churn=True, key_space=args.keys, device=args.device,
        )
    )
    print(
        f"key-churn: {r['decisions_per_sec']:>14,.0f} dec/s "
        f"(dropped->sketch {r['dropped_creates']}, promoter "
        f"{r.get('promoter')})",
        file=sys.stderr,
    )
    if args.json:
        print(
            json.dumps(
                dict(
                    scenario="key_churn",
                    scope=_device_info(args.device)["platform"],
                    store_mib=args.store_mib,
                    key_space=args.keys,
                    depth=depth,
                    rows=[r],
                )
            )
        )
    return 0


def run_shed(args) -> int:
    """Over-limit-heavy serving scenario (r10): the shed cache's home
    turf, through the SHIPPED boot path.

    Boots env knobs -> config_from_env (GUBER_SHED_CACHE honored and
    recorded) -> make_backend -> Instance, then drives token-bucket
    traffic whose OVER-LIMIT SHARE is controlled per round: a hot pool
    of limit-1 keys (over limit from their second hit, frozen for the
    whole run) mixed with never-over keys at the round's target ratio.
    Each round reports measured over-limit share, decisions/s, and the
    shed cache's hit rate — the skew ladder `make profile-shed` A/Bs
    ON vs OFF over the edge door (BENCH_SHED_r10.json).
    """
    import asyncio
    import os

    from gubernator_tpu_torch.api.types import RateLimitReq, Status
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.backends import make_backend
    from gubernator_tpu_torch.serve.instance import Instance

    env = dict(os.environ)
    env.setdefault("GUBER_BACKEND", args.backend)
    # a syntactically-valid self address: the in-process instance never
    # dials itself, but the ring refuses port 0 at connect()
    env.setdefault("GUBER_GRPC_ADDRESS", "127.0.0.1:19099")
    conf = config_from_env(env)
    backend = make_backend(conf, device=_dev(args.device))
    shares = [
        float(s) for s in args.shed_shares.split(",") if s.strip()
    ]
    rows = []

    async def run_rounds():
        from gubernator_tpu_torch.api.types import PeerInfo

        warmup = getattr(backend, "warmup", None)
        if warmup is not None:
            print("warmup (every ladder rung once)...", file=sys.stderr)
            await asyncio.to_thread(warmup)
        inst = Instance(conf, backend)
        inst.start()
        await inst.set_peers(
            [PeerInfo(address=conf.resolved_advertise(), is_owner=True)]
        )
        try:
            HOT, COLD, GROUP = 512, 4096, 256

            def batch_for(share: float, w: int, i: int):
                cut = int(share * GROUP)
                reqs = []
                for j in range(GROUP):
                    if j < cut:
                        k, limit = f"h{(i * 31 + j) % HOT}", 1
                    else:
                        k, limit = (
                            f"c{(w * 7919 + i * GROUP + j) % COLD}",
                            1_000_000_000,
                        )
                    reqs.append(
                        RateLimitReq(
                            name="shed", unique_key=k, hits=1,
                            limit=limit, duration=600_000,
                        )
                    )
                return reqs

            for share in shares:
                # warm pass freezes the hot pool over limit
                for i in range(4):
                    await inst.get_rate_limits(batch_for(1.0, 0, i))
                if inst.shed is not None:
                    inst.shed.reset_counters()
                stop_at = time.monotonic() + args.seconds
                done = over = 0

                async def worker(w: int):
                    nonlocal done, over
                    i = 0
                    while time.monotonic() < stop_at:
                        resps = await inst.get_rate_limits(
                            batch_for(share, w, i)
                        )
                        done += len(resps)
                        over += sum(
                            1 for r in resps
                            if r.status == Status.OVER_LIMIT
                        )
                        i += 1

                t0 = time.monotonic()
                await asyncio.gather(*[worker(w) for w in range(8)])
                elapsed = time.monotonic() - t0
                shed_stats = (
                    inst.shed.stats() if inst.shed is not None else None
                )
                r = dict(
                    metric="shed_overlimit_serving",
                    target_over_limit_share=share,
                    over_limit_share=round(over / done, 4) if done else 0,
                    decisions_per_sec=round(done / elapsed, 1),
                    seconds=round(elapsed, 3),
                    shed=shed_stats,
                )
                print(
                    f"share {share:.2f}: "
                    f"{r['decisions_per_sec']:>12,.0f} dec/s  "
                    f"(over-limit {r['over_limit_share']:.2f}, shed "
                    f"hit-rate "
                    f"{shed_stats['hit_rate'] if shed_stats else '-'}"
                    f")",
                    file=sys.stderr,
                )
                rows.append(r)
        finally:
            await inst.stop()

    asyncio.run(run_rounds())
    doc = dict(
        scenario="shed_overlimit",
        backend=conf.backend,
        served_via=(
            "config_from_env -> make_backend -> Instance "
            "(instance-tier shed screen); the bridge-tier A/B lives "
            "in scripts/profile_shed.py"
        ),
        env_knobs={
            "GUBER_BACKEND": conf.backend,
            "GUBER_SHED_CACHE": env.get("GUBER_SHED_CACHE", "1"),
            "GUBER_SHED_CACHE_KEYS": env.get(
                "GUBER_SHED_CACHE_KEYS", "<default>"
            ),
            "GUBER_PREP_AT_ARRIVAL": env.get(
                "GUBER_PREP_AT_ARRIVAL", "1"
            ),
        },
        rows=rows,
    )
    if args.json:
        print(json.dumps(doc))
    return 0


def _algo_env(args):
    """GUBER_* env for the r15 algorithm scenarios: the shipped boot
    path on the device backend, moderate store, shed cache OFF so the
    token arm of an A/B pays the same host path as the non-sheddable
    algorithms."""
    import os

    depth = int(args.depths.split(",")[0])
    env = dict(os.environ)
    env.update(
        {
            "GUBER_BACKEND": "tpu",
            "GUBER_DEVICE_BATCH_LIMIT": str(depth),
            "GUBER_DEVICE_DEEP_BATCH": "1",
            "GUBER_STORE_SLOTS": str(1 << 14),
            "GUBER_SHED_CACHE": "0",
            "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
        }
    )
    env.pop("GUBER_STORE_MIB", None)
    env.pop("GUBER_STORE_TARGET_KEYS", None)
    return env, depth


def run_flash_crowd(args) -> int:
    """Flash-crowd scenario (r15): `--algorithm` under a suddenly-hot
    key set that rotates every phase (cli/keystreams.flash_crowd_pool)
    over the zipf background. The algorithm-suite shape: a fixed
    window admits ~2x limit around each boundary of a crowd this
    bursty; the sliding blend and GCRA's emission spacing do not.
    Reports dec/s plus the over-limit share the algorithm enforced."""
    import asyncio

    import numpy as np

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.core.algorithms import ALGO_NAMES
    from gubernator_tpu_torch.serve.config import config_from_env

    env, depth = _algo_env(args)
    conf = config_from_env(env)
    algo_id = ALGO_NAMES[args.algorithm]
    group = min(args.group, depth)
    limit, duration = 200, 1000

    async def run():
        inst, backend, warm_s = await _boot_stack(
            conf, f"flash_crowd_{args.algorithm}", depth, args.device
        )
        try:
            stop_at = time.monotonic() + args.seconds
            done = 0
            over = 0
            t0 = time.monotonic()

            async def worker(w: int):
                nonlocal done, over
                ones = np.ones(group, np.int64)
                algo = np.full(group, algo_id, np.int32)
                passes = 0
                while time.monotonic() < stop_at:
                    # the crowd rotates every ~500ms: a fresh flash
                    phase = int((time.monotonic() - t0) * 2)
                    passes += 1
                    kh = keystreams.flash_crowd_pool(
                        1 << 20, group, phase,
                        rng=np.random.default_rng(
                            phase * 1000 + passes * 17 + w
                        ),
                    )
                    status, _l, _r, _t = (
                        await inst.batcher.decide_arrays(
                            dict(
                                key_hash=kh, hits=ones,
                                limit=ones * limit,
                                duration=ones * duration,
                                algo=algo,
                            )
                        )
                    )
                    done += group
                    over += int(np.sum(np.asarray(status) != 0))

            workers = max(8, 2 * depth // group)
            await asyncio.gather(*[worker(w) for w in range(workers)])
            elapsed = time.monotonic() - t0
            return dict(
                metric=f"flash_crowd_{args.algorithm}",
                algorithm=args.algorithm,
                depth=depth,
                decisions_per_sec=round(done / elapsed, 1),
                over_limit_share=round(over / max(done, 1), 4),
                limit=limit,
                duration_ms=duration,
                seconds=round(elapsed, 3),
                workers=workers,
                group_rows=group,
                warmup_seconds=round(warm_s, 1),
            )
        finally:
            await inst.stop()

    row = asyncio.run(run())
    print(
        f"flash-crowd[{args.algorithm}]: "
        f"{row['decisions_per_sec']:>12,.0f} dec/s  "
        f"over-limit {row['over_limit_share']:.1%}",
        file=sys.stderr,
    )
    if args.json:
        print(json.dumps(dict(
            scenario="flash_crowd",
            scope=_device_info(args.device)["platform"],
            rows=[row],
        )))
    return 0


def run_mixed_tenant_zipf(args) -> int:
    """Mixed-tenant quota-chain scenario (r15): every request names a
    global -> (region ->) tenant chain (depth = --chain-depth) over a
    zipf tenant draw (keystreams.tenant_zipf_ids) — the multi-tenant
    front door quota chains exist for. Drives the batcher's dedicated
    chain lane (object path, one coalesced chain-coupled kernel pass
    per flush); reports chains/s, device rows/s (the expansion
    factor), refusal share, and which level refused."""
    import asyncio
    import collections

    import numpy as np

    from gubernator_tpu_torch.api.types import ChainLevel, RateLimitReq
    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.serve.config import config_from_env

    env, depth = _algo_env(args)
    conf = config_from_env(env)
    d = max(1, min(int(args.chain_depth), 3))
    tenants = 64
    chain_group = 256
    # ancestors, shallow to deep; truncated to depth KEEPING the head
    # (the consolidation contract routes every chain by chain[0])
    # tenant limit sized so the zipf head tenant (~18% of traffic at
    # a=1.2) exhausts its quota inside a few bench seconds — the
    # most-restrictive-wins refusals are the scenario's point
    lv_limits = {"global": 1 << 30, "region": 1 << 24, "tenant": 1200}

    async def run():
        inst, backend, warm_s = await _boot_stack(
            conf, f"tenant_chain_d{d}", depth, args.device
        )
        try:
            stop_at = time.monotonic() + args.seconds
            done = 0
            refused = 0
            level_hist = collections.Counter()
            t0 = time.monotonic()

            async def worker(w: int):
                nonlocal done, refused
                rng = np.random.default_rng(100 + w)
                passes = 0
                while time.monotonic() < stop_at:
                    passes += 1
                    ts = keystreams.tenant_zipf_ids(
                        tenants, chain_group, rng
                    )
                    reqs = []
                    for j, t in enumerate(ts):
                        chain = [
                            ChainLevel("global", lv_limits["global"], 0),
                            ChainLevel(
                                f"region:{int(t) % 4}",
                                lv_limits["region"], 0,
                            ),
                            ChainLevel(
                                f"tenant:{int(t)}",
                                lv_limits["tenant"], 0,
                            ),
                        ][-d:]
                        # keep ONE head per hierarchy: depth-truncated
                        # chains still start at the deepest kept level
                        reqs.append(RateLimitReq(
                            name="mtz",
                            unique_key=(
                                f"k:{int(t)}:"
                                f"{int(rng.integers(1 << 14))}"
                            ),
                            hits=1,
                            limit=1 << 20,
                            duration=60_000,
                            chain=chain,
                        ))
                    resps = await inst.batcher.decide_chain(reqs)
                    done += len(resps)
                    for r in resps:
                        if int(r.status) != 0:
                            refused += 1
                            level_hist[
                                r.metadata.get("chain_level", "leaf")
                            ] += 1

            await asyncio.gather(*[worker(w) for w in range(8)])
            elapsed = time.monotonic() - t0
            return dict(
                metric=f"tenant_chain_depth{d}",
                chain_depth=d,
                tenants=tenants,
                chains_per_sec=round(done / elapsed, 1),
                device_rows_per_sec=round(done * (d + 1) / elapsed, 1),
                refusal_share=round(refused / max(done, 1), 4),
                refusing_level=dict(level_hist),
                seconds=round(elapsed, 3),
                warmup_seconds=round(warm_s, 1),
            )
        finally:
            await inst.stop()

    row = asyncio.run(run())
    print(
        f"mixed-tenant-zipf[d{d}]: {row['chains_per_sec']:>10,.0f} "
        f"chains/s ({row['device_rows_per_sec']:,.0f} rows/s, "
        f"refused {row['refusal_share']:.1%})",
        file=sys.stderr,
    )
    if args.json:
        print(json.dumps(dict(
            scenario="mixed_tenant_zipf",
            scope=_device_info(args.device)["platform"],
            rows=[row],
        )))
    return 0


def run_gcra_vs_token(args) -> int:
    """GCRA-vs-token fairness A/B (r15): one hot key under demand far
    above its limit, token bucket then GCRA on fresh stacks. The
    token window admits its whole budget at the window start and
    refuses the rest (bursty admission: long refusal runs, high
    inter-admission-gap variance); GCRA's emission interval spaces
    the SAME average admission rate evenly. Reported per arm:
    admitted/s, max refusal run, and the coefficient of variation of
    inter-admission gaps — the fairness number (lower = smoother)."""
    import asyncio

    import numpy as np

    from gubernator_tpu_torch.cli import keystreams
    from gubernator_tpu_torch.core.algorithms import ALGO_NAMES
    from gubernator_tpu_torch.serve.config import config_from_env

    env, depth = _algo_env(args)
    limit, duration = 50, 2000

    async def one_arm(algo_name: str) -> dict:
        conf = config_from_env(env)
        inst, backend, warm_s = await _boot_stack(
            conf, f"gcra_vs_token_{algo_name}", depth, args.device
        )
        try:
            algo_id = ALGO_NAMES[algo_name]
            kh = keystreams.hash_ids(np.array([7], np.uint64))
            one = np.ones(1, np.int64)
            algo = np.full(1, algo_id, np.int32)
            stop_at = time.monotonic() + args.seconds
            admits = []
            statuses = []
            while time.monotonic() < stop_at:
                status, _l, _r, _t = (
                    await inst.batcher.decide_arrays(
                        dict(
                            key_hash=kh, hits=one,
                            limit=one * limit,
                            duration=one * duration, algo=algo,
                        )
                    )
                )
                ok = int(np.asarray(status)[0]) == 0
                statuses.append(ok)
                if ok:
                    admits.append(time.monotonic())
            gaps = np.diff(np.asarray(admits))
            run_len = max_run = 0
            for ok in statuses:
                run_len = 0 if ok else run_len + 1
                max_run = max(max_run, run_len)
            cv = (
                float(np.std(gaps) / np.mean(gaps))
                if gaps.size > 1 and np.mean(gaps) > 0
                else 0.0
            )
            return dict(
                algorithm=algo_name,
                requests=len(statuses),
                admitted=len(admits),
                admitted_per_sec=round(
                    len(admits) / args.seconds, 1
                ),
                max_refusal_run=max_run,
                admission_gap_cv=round(cv, 3),
                limit=limit,
                duration_ms=duration,
                warmup_seconds=round(warm_s, 1),
            )
        finally:
            await inst.stop()

    rows = []
    for name in ("token", "gcra"):
        r = asyncio.run(one_arm(name))
        rows.append(r)
        print(
            f"gcra-vs-token[{name}]: {r['admitted']} admitted "
            f"of {r['requests']}  gap-CV {r['admission_gap_cv']} "
            f"max-refusal-run {r['max_refusal_run']}",
            file=sys.stderr,
        )
    if args.json:
        print(json.dumps(dict(
            scenario="gcra_vs_token",
            scope=_device_info(args.device)["platform"],
            note=(
                "same demand, same average admission rate; GCRA's "
                "emission interval spreads admissions evenly where "
                "the token window grants its whole budget at the "
                "window start — compare admission_gap_cv and "
                "max_refusal_run, not admitted_per_sec"
            ),
            rows=rows,
        )))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="serving benchmarks")
    parser.add_argument("--backend", default="exact")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the device backends run: the card (default; fails "
        "without one) or the CPU",
    )
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--nodes", type=int, default=6)
    parser.add_argument("--json", action="store_true")
    parser.add_argument(
        "--scenario",
        default="cluster",
        choices=[
            "cluster", "zipf10m", "zipf100m", "key-churn", "shed",
            "shard", "flash-crowd", "mixed-tenant-zipf",
            "gcra-vs-token",
        ],
        help="cluster = the reference benchmark suite over localhost "
        "gRPC; zipf10m = BASELINE config 4 through the shipped serving "
        "config (deep-batch ladder, GUBER_STORE_MIB-sized store); "
        "zipf100m = the r13 two-tier flagship: 100M-key zipf at the "
        "SAME fixed budget (sketch carve-out) vs the exact-only 10M "
        "baseline, plus the measured tail-error phase with the r21 "
        "derivation A/B and sliding/gcra window-ring arms "
        "(BENCH_SKETCH_r21.json); key-churn = adversarial fresh-keys-"
        "every-pass stream (tier thrash worst case, ROADMAP item 4); "
        "shed = over-limit-heavy skew ladder through the shipped boot "
        "path (the r10 shed cache's workload; GUBER_SHED_CACHE "
        "honored and recorded, over-limit share reported per round); "
        "flash-crowd = suddenly-hot rotating key set under "
        "--algorithm (r15 suite); mixed-tenant-zipf = quota chains "
        "over a zipf tenant draw at --chain-depth; gcra-vs-token = "
        "single-hot-key admission-fairness A/B; shard = the mesh "
        "shard-count ladder (--shards) over the local devices",
    )
    parser.add_argument(
        "--algorithm",
        default="sliding",
        choices=["token", "leaky", "sliding", "gcra"],
        help="flash-crowd: the rate-limit algorithm under test "
        "(core/algorithms.py registry names)",
    )
    parser.add_argument(
        "--chain-depth",
        type=int,
        default=3,
        help="mixed-tenant-zipf: ancestor levels per request (1-3; "
        "3 = global -> region -> tenant above the leaf)",
    )
    parser.add_argument(
        "--rounds", type=int, default=3,
        help="zipf100m: interleaved paired baseline/sketch rounds",
    )
    parser.add_argument(
        "--shards", default="1,2,4,8",
        help="shard scenario: comma list of mesh shard counts, laid over "
        "the local devices in turn (a flat 1-shard row is always "
        "included as the degenerate-policy baseline)",
    )
    parser.add_argument(
        "--shard-depth", type=int, default=8192,
        help="shard scenario: GUBER_DEVICE_BATCH_LIMIT per rung",
    )
    parser.add_argument(
        "--shard-slots", type=int, default=1 << 12,
        help="shard scenario: GUBER_STORE_SLOTS per rung (per-shard "
        "table geometry is identical across the ladder)",
    )
    parser.add_argument(
        "--shed-shares",
        default="0.0,0.3,0.6,0.9",
        help="shed scenario: comma list of target over-limit traffic "
        "shares, one measurement round each",
    )
    parser.add_argument(
        "--depths",
        default="4096,16384,32768,131072",
        help="zipf10m: comma list of GUBER_DEVICE_BATCH_LIMIT rungs",
    )
    parser.add_argument(
        "--keys", type=int, default=10_000_000,
        help="zipf10m: live-key budget (GUBER_STORE_TARGET_KEYS)",
    )
    parser.add_argument(
        "--store-mib", type=int, default=1024,
        help="zipf10m: fixed store footprint (GUBER_STORE_MIB)",
    )
    parser.add_argument(
        "--group", type=int, default=4096,
        help="zipf10m: rows per caller group (edge-frame shape)",
    )
    parser.add_argument(
        "--edge",
        action="store_true",
        help="also bench through the native C++ edge (built from "
        "gubernator_tpu_torch/native/edge with g++ at first use)",
    )
    parser.add_argument(
        "--edge-only",
        action="store_true",
        help="with --edge: run ONLY the edge-door scenarios (skip the "
        "reference suite) — the A/B loop for protocol comparisons",
    )
    parser.add_argument(
        "--edge-bin",
        default="",
        help="path to an alternative guber-edge binary (e.g. a pre-r7 "
        "build for a windowed-vs-roundtrip protocol A/B); default: the "
        "in-tree build",
    )
    parser.add_argument(
        "--edge-workers",
        type=int,
        default=2,
        help="edge backend connections (guber-edge --workers). The "
        "windowed protocol (r7) keeps N frames in flight per "
        "connection, so the binary's default 2 suffices; pre-r7 "
        "builds needed 8 to hide the one-frame-per-roundtrip wait",
    )
    parser.add_argument(
        "--edge-clients",
        type=int,
        default=16,
        help="concurrent client threads for edge_grpc_batched_"
        "concurrent (in-flight frame demand; past the backend "
        "connection count only a windowed edge can keep them all "
        "moving)",
    )
    parser.add_argument(
        "--fetch-depth",
        type=int,
        default=None,
        help="in-flight device batches per node (GUBER_FETCH_DEPTH)",
    )
    parser.add_argument(
        "--prep-at-arrival",
        choices=["0", "1"],
        default=None,
        help="override GUBER_PREP_AT_ARRIVAL for every node this "
        "harness boots (r9 host-prep pipeline A/B; default: env / on)",
    )
    args = parser.parse_args(argv)
    if args.fetch_depth is not None:
        import os

        os.environ["GUBER_FETCH_DEPTH"] = str(args.fetch_depth)
    if args.prep_at_arrival is not None:
        import os

        os.environ["GUBER_PREP_AT_ARRIVAL"] = args.prep_at_arrival
    if args.scenario == "flash-crowd":
        return run_flash_crowd(args)
    if args.scenario == "mixed-tenant-zipf":
        return run_mixed_tenant_zipf(args)
    if args.scenario == "gcra-vs-token":
        return run_gcra_vs_token(args)
    if args.scenario == "shed":
        if args.backend == "exact":
            print(
                "shed is a device scenario by default: using "
                "--backend tpu (pass GUBER_BACKEND=exact to force)",
                file=sys.stderr,
            )
            args.backend = "tpu"
        return run_shed(args)
    if args.scenario == "zipf10m":
        if args.backend == "exact":
            # config 4 is a device scenario (the exact backend decides
            # inline and cannot deep-batch; config.validate refuses the
            # combination) — remap the cluster-suite default, loudly
            print(
                "zipf10m is a device scenario: using --backend tpu "
                "(exact cannot deep-batch)",
                file=sys.stderr,
            )
            args.backend = "tpu"
        return run_zipf10m(args)
    if args.scenario == "zipf100m":
        # two-tier defaults: one deep rung, 100M-key space when the
        # user left the zipf10m defaults in place
        if args.depths == parser.get_default("depths"):
            args.depths = "32768"
        if args.keys == parser.get_default("keys"):
            args.keys = 100_000_000
        return run_zipf100m(args)
    if args.scenario == "key-churn":
        if args.depths == parser.get_default("depths"):
            args.depths = "32768"
        return run_churn(args)
    if args.scenario == "shard":
        return run_shard(args)

    backend_factory = None
    # device backends boot with the daemon's shipped co-batch depth
    # (GUBER_DEVICE_BATCH_LIMIT, default 8192 here): the windowed edge
    # keeps many frames in flight per connection (r7), and the device
    # batcher folds those concurrent ~1000-item groups into one deep
    # launch — each node runs every ladder rung once at boot exactly as
    # the daemon does (Server.start), so this is the served path, not a
    # bench-only trick.
    import os as _os

    device_limit = int(
        _os.environ.get("GUBER_DEVICE_BATCH_LIMIT", "8192")
    )
    if args.backend == "exact":
        from gubernator_tpu_torch.serve.backends import ExactBackend

        backend_factory = lambda: ExactBackend(100_000)  # noqa: E731
    elif args.backend == "mesh":
        from gubernator_tpu_torch.core.engine import buckets_for_limit
        from gubernator_tpu_torch.core.store import StoreConfig
        from gubernator_tpu_torch.parallel.policy import local_devices
        from gubernator_tpu_torch.serve.backends import MeshBackend

        # the reference's store shape, a shard for each local device
        backend_factory = lambda: MeshBackend(  # noqa: E731
            StoreConfig(rows=16, slots=1 << 12),
            devices=local_devices(_dev(args.device)),
            buckets=buckets_for_limit(device_limit),
        )
    elif args.backend == "tpu":
        from gubernator_tpu_torch.core.engine import buckets_for_limit
        from gubernator_tpu_torch.core.store import StoreConfig
        from gubernator_tpu_torch.serve.backends import TorchBackend

        # the reference's store shape for its tpu and mesh runs
        backend_factory = lambda: TorchBackend(  # noqa: E731
            StoreConfig(rows=16, slots=1 << 12),
            buckets=buckets_for_limit(device_limit),
            device=_dev(args.device),
        )
    else:
        # an unknown name silently benching the wrong backend would
        # publish numbers under a false label
        parser.error(f"unknown --backend {args.backend!r}")

    device_backend = args.backend in ("tpu", "mesh")

    # node 0 also serves the Python HTTP/JSON gateway so the edge's
    # front-door multiplier is a measured comparison, not a claim
    # (gated on --edge: gRPC-only runs must not fail on a busy port)
    http_addresses = [""] * args.nodes
    if args.edge:
        http_addresses[0] = PYTHON_HTTP_ADDR
    cluster = LocalCluster(
        ADDRESSES[: args.nodes],
        backend_factory=backend_factory,
        http_addresses=http_addresses,
        env=(
            {"GUBER_DEVICE_BATCH_LIMIT": str(device_limit)}
            if device_backend
            else None
        ),
    )
    print("starting cluster...", file=sys.stderr)
    # device nodes boot one after another, each running every ladder
    # rung once (the first also builds the writeback kernel); the
    # default 90 s bound is for host nodes
    cluster.start(timeout=120 + (300 * args.nodes if device_backend else 0))
    try:
        target = cluster.peer_at(0)
        chan = grpc.insecure_channel(target)
        v1 = V1Stub(chan)
        peers = PeersV1Stub(chan)

        results = []

        def no_batching(i: int):
            peers.GetPeerRateLimits(
                peers_pb2.GetPeerRateLimitsReq(requests=[_req(f"k{i % 1000}")]),
                timeout=CALL_TIMEOUT_S,
            )

        def get_rate_limit(i: int):
            v1.GetRateLimits(
                gubernator_pb2.GetRateLimitsReq(
                    requests=[_req(f"k{i % 1000}")]
                ),
                timeout=CALL_TIMEOUT_S,
            )

        def ping(i: int):
            v1.HealthCheck(
                gubernator_pb2.HealthCheckReq(), timeout=CALL_TIMEOUT_S
            )

        # per-worker channels for the herd so one channel isn't the choke
        herd_stubs: List[V1Stub] = [
            V1Stub(grpc.insecure_channel(cluster.get_peer()))
            for _ in range(100)
        ]

        def herd(i: int):
            herd_stubs[i % 100].GetRateLimits(
                gubernator_pb2.GetRateLimitsReq(
                    requests=[_req(f"k{i % 1000}")]
                ),
                timeout=CALL_TIMEOUT_S,
            )

        batch = gubernator_pb2.GetRateLimitsReq(
            requests=[_req(f"k{i}") for i in range(1000)]
        )

        def batched(i: int):
            v1.GetRateLimits(batch, timeout=CALL_TIMEOUT_S)

        # GLOBAL behavior against node 0 (mixed owners: replica answers
        # locally, hits gossip async) — BASELINE config 3's latency
        # scenario; its target is p99 < 1ms
        def global_req(i: int):
            r = _req(f"g{i % 1000}")
            r.behavior = gubernator_pb2.GLOBAL
            return r

        def global_call(i: int):
            v1.GetRateLimits(
                gubernator_pb2.GetRateLimitsReq(requests=[global_req(i)]),
                timeout=CALL_TIMEOUT_S,
            )

        # optional: front node 0 with the native edge (HTTP/JSON in C++,
        # batched frames into the same instance) and measure through it
        edge_proc = None
        edge_bridge = None
        sock = None
        if args.edge:
            import json as _json
            import os
            import pathlib
            import subprocess
            import tempfile

            if args.edge_bin:
                edge_bin = pathlib.Path(args.edge_bin)
                if not edge_bin.exists():
                    print(f"edge binary {edge_bin} missing", file=sys.stderr)
                    return 1
            else:
                from gubernator_tpu_torch.native import edge_build

                edge_bin = edge_build.build()  # g++, at first use
            sock = os.path.join(
                tempfile.gettempdir(), f"guber-bench-edge-{os.getpid()}.sock"
            )
            try:
                os.unlink(sock)
            except FileNotFoundError:
                pass
            edge_bridge = cluster.run(
                _attach_edge_bridge(cluster.servers[0], sock)
            )
            edge_port = EDGE_PORT
            edge_grpc_port = EDGE_GRPC_PORT
            edge_proc = subprocess.Popen(
                [str(edge_bin), "--listen", str(edge_port),
                 "--grpc-listen", str(edge_grpc_port),
                 "--backend", sock, "--workers",
                 str(args.edge_workers)],
                # the edge's stderr is ours: it names any lane or credit
                # wait that outlasts a second (native/edge/edge.cc)
                stdout=subprocess.DEVNULL,
            )
            # poll for readiness instead of hoping a fixed sleep suffices
            import socket as _socket

            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    _socket.create_connection(
                        ("127.0.0.1", edge_port), timeout=1
                    ).close()
                    break
                except OSError:
                    time.sleep(0.05)
            edge_body = _json.dumps(
                {
                    "requests": [
                        {"name": "edge", "uniqueKey": "K", "hits": 1,
                         "limit": 1000000, "duration": 10000}
                    ]
                }
            ).encode()

            through_edge = _front_door_call(
                f"http://127.0.0.1:{edge_port}/v1/GetRateLimits", edge_body
            )

            # same workload against node 0's Python HTTP gateway: the
            # apples-to-apples denominator for the edge multiplier
            # (skipped under --edge-only: the A/B loop compares edge
            # binaries, not doors)
            if not args.edge_only:
                results.append(
                    _measure(
                        "python_http_front_door",
                        _front_door_call(
                            f"http://{PYTHON_HTTP_ADDR}/v1/GetRateLimits",
                            edge_body,
                        ),
                        args.seconds, workers=16,
                    )
                )
                results.append(
                    _measure("edge_front_door", through_edge,
                             args.seconds, workers=16)
                )

            # BASELINE config 3's honest low-concurrency restatement:
            # ONE client, GLOBAL behavior, through the compiled edge —
            # the reference's "most responses < 1ms" is a per-response
            # production latency, not a saturated-tail number
            if not args.edge_only:
                global_edge_body = _json.dumps(
                    {
                        "requests": [
                            {"name": "edge", "uniqueKey": "G", "hits": 1,
                             "limit": 1000000, "duration": 10000,
                             "behavior": "GLOBAL"}
                        ]
                    }
                ).encode()
                results.append(
                    _measure(
                        "global_1way_edge",
                        _front_door_call(
                            f"http://127.0.0.1:{edge_port}"
                            "/v1/GetRateLimits",
                            global_edge_body,
                        ),
                        args.seconds, workers=1,
                    )
                )

            # gRPC front doors under the SAME 16-way single-item load:
            # the compiled edge terminates h2/HPACK/proto itself
            # (native/edge/h2_grpc.inc) vs the Python grpc.aio listener
            # whose 16-way tail collapse r3 measured. Per-worker
            # channels, like the herd.
            one_req = gubernator_pb2.GetRateLimitsReq(
                requests=[_req("K")]
            )

            def _grpc_door(target):
                stubs = [
                    V1Stub(grpc.insecure_channel(target))
                    for _ in range(16)
                ]

                def call(i: int):
                    stubs[(i // 1_000_000) % 16].GetRateLimits(
                        one_req, timeout=CALL_TIMEOUT_S
                    )

                return call

            if not args.edge_only:
                results.append(
                    _measure(
                        "python_grpc_front_door",
                        _grpc_door(cluster.peer_at(0)),
                        args.seconds, workers=16,
                    )
                )
                results.append(
                    _measure(
                        "edge_grpc_front_door",
                        _grpc_door(f"127.0.0.1:{edge_grpc_port}"),
                        args.seconds, workers=16,
                    )
                )

            # and the batched saturation shape through the edge's gRPC
            # door — on device backends this rides the pre-hashed GEB6
            # array path end-to-end
            batch_1000 = gubernator_pb2.GetRateLimitsReq(
                requests=[_req(f"k{i}") for i in range(1000)]
            )
            n_ec = args.edge_clients
            eg_stubs = [
                V1Stub(
                    grpc.insecure_channel(f"127.0.0.1:{edge_grpc_port}")
                )
                for _ in range(n_ec)
            ]

            def edge_grpc_batched(i: int):
                eg_stubs[(i // 1_000_000) % n_ec].GetRateLimits(
                    batch_1000, timeout=CALL_TIMEOUT_S
                )

            eb = _measure(
                "edge_grpc_batched_concurrent", edge_grpc_batched,
                args.seconds, workers=n_ec,
            )
            eb["decisions_per_sec"] = round(eb["ops_per_sec"] * 1000, 1)
            print(
                f"{'':18s} -> {eb['decisions_per_sec']:12,.0f} decisions/s",
                file=sys.stderr,
            )
            results.append(eb)

        if not args.edge_only:
            results.append(
                _measure("no_batching", no_batching, args.seconds)
            )
            results.append(
                _measure("get_rate_limit", get_rate_limit, args.seconds)
            )
            results.append(_measure("ping", ping, args.seconds))
            results.append(_measure("global", global_call, args.seconds))
            results.append(
                _measure(
                    "thundering_herd", herd, args.seconds, workers=100
                )
            )
            b = _measure("batched", batched, args.seconds)
            b["decisions_per_sec"] = round(b["ops_per_sec"] * 1000, 1)
            print(
                f"{'':18s} -> {b['decisions_per_sec']:12,.0f} "
                "decisions/s",
                file=sys.stderr,
            )
            results.append(b)

            # 16 concurrent clients each sending 1000-item batches: the
            # saturation shape. One outstanding call per client means
            # the single-client "batched" row measures round-trip
            # latency, not capacity; with the batcher's fetch_depth
            # pipeline the service overlaps many device batches, which
            # only concurrency exposes.
            conc_stubs: List[V1Stub] = [
                V1Stub(grpc.insecure_channel(cluster.peer_at(0)))
                for _ in range(16)
            ]

            def batched_concurrent(i: int):
                # call index is w*1_000_000 + seq: key the stub by
                # worker so each client thread owns one channel
                # end-to-end
                conc_stubs[(i // 1_000_000) % 16].GetRateLimits(
                    batch, timeout=CALL_TIMEOUT_S
                )

            bc = _measure(
                "batched_concurrent", batched_concurrent, args.seconds,
                workers=16,
            )
            bc["decisions_per_sec"] = round(bc["ops_per_sec"] * 1000, 1)
            print(
                f"{'':18s} -> {bc['decisions_per_sec']:12,.0f} "
                "decisions/s",
                file=sys.stderr,
            )
            results.append(bc)

        if args.json:
            doc = {
                "backend": args.backend,
                "nodes": args.nodes,
                "seconds_per_scenario": args.seconds,
                "results": results,
            }
            if device_backend:
                info = _device_info(args.device)
                doc["device"] = info["kind"]
                doc["n_devices"] = info["count"]
            print(json.dumps(doc))
        return 0
    finally:
        try:
            if "edge_proc" in locals() and edge_proc is not None:
                edge_proc.kill()
                edge_proc.wait(timeout=5)
            if "edge_bridge" in locals() and edge_bridge is not None:
                cluster.run(edge_bridge.stop())
            if "sock" in locals() and sock is not None:
                os.unlink(sock)
        except Exception:
            pass
        cluster.stop()


if __name__ == "__main__":
    sys.exit(main())
