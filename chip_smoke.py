"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (gubernator_tpu_torch) through the entry points a user
calls (the engine, the serving core, the daemon's doors, a cluster of
nodes forwarding to each other, the GEB frame doors with the compiled
edge in front, hierarchical quota chains, durability: checkpoint and
restore, bucket replication and ring rescale, the workloads: the
serving benchmarks' scenarios and three daemons driven by the load
generator, and discovery: daemons finding each other through etcd and
the chaos soak's three modes), at two of the repo's deployments:

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
  first at the engine (TorchEngine), then through the serving core;
  quota chains run on it with the repo's mixed_tenant_zipf traffic
  (gubernator_tpu/cli/bench_serving.py:1355): global (2^30) -> region:{t%4}
  (2^24) -> tenant:{t} (1,200) above the leaf k:{t}:{0..2^14} (2^20),
  t zipf(1.2) mod 64, hits 1, 60 s: 4 device rows a chained request.

All use device batches of 32,768 (the ladder buckets_for_limit(32768)).
Phases, one JSON line each:

1. build     compile csrc/writeback.cu with nvcc (seconds), and beside it,
             with g++, the compiled edge (native/edge/) and the native
             hasher and prep library (native/guberhash.cc); the run fails
             unless the store then hashes XXH64 (using_native_hash());
   hash      the native hasher and prep on the host: the XXH64 vectors;
             at 32,768 zipf100m rows the native presort, prep_run and
             merge byte-identical to the port's numpy twins; host us a
             call, native against numpy, of hash_batch (4,096 keys), the
             presort, prep_run (4,096 rows) and the merge of 8 runs;
2. kernel    the copy-floor kernel (x += 1, the port of scripts/bench_hbm.py's
             identity sweep) against x.add_(1), bit for bit, and timed at
             16 MiB (in the 50 MB L2), 512 MiB and 1 GiB (the two stores):
             the bytes/s a pass over the store reaches, and vs_library, its
             time over x.add_(1)'s in the same run; then
             the writeback kernel against its plain version, bit for bit,
             at the exact path's shape (2^21 buckets, G of a zipf batch),
             the sweep's own regime (4096 buckets, B=32768) and the
             two-tier path's shape (2^20 buckets, G of a zipf100m batch):
             ms / plain_ms / library_ms are device time per call of a run
             of back-to-back calls (CUDA events around the run, over the
             count), cycling through 8 batches whose rows exceed the L2
             cache; bound_ms is bytes over the H100's 3.35 TB/s, and
             share_of_floor the same bytes over the measured floor at the
             store's size: the fastest of add_one, its plain version and
             x.add_(1) there (floor_by names which);
   ablation  the writeback ablation (cli/ablate_writeback.py, the port of
             scripts/ablate_sweep.py): its steps rows, deltas and full at
             kRows 4, 8 and 16, each bit for bit against its plain version
             and timed beside its one PyTorch call, at the script's shape
             (16 MiB, in the L2) and the two-tier path's, where each step
             at kRows 8 is also timed on one batch repeated, in the L2
             (one_set_vs_all);
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
             script with --rpc-window), off the nodes' event loop; the
             checked leg also sends fast frames through a ring-routing
             GebClient on node 0's GEB door (each node has one), each
             key's frame to its owner's door, identical to the CPU's;
9. geb       the daemon again, now with GUBER_GEB_PORT, GUBER_EDGE_SOCKET
             and GUBER_EDGE_TCP, and the port's guber-edge in front of the
             unix socket: hello flags of each door (fast on the GEB door
             and /v1/geb and the edge bridge, all with XXH64, shm on the
             unix socket), a
             limit-2 walk through a fast frame, a string frame, POST
             /v1/geb, the shm lane, the edge's HTTP JSON and its gRPC,
             one key counted by the fast door and the edge's fast frames
             in turn; six
             windows of >= 5 s, their callers in a client process (this
             script with --geb-window): geb_1000 (16 connections, fast
             frames of 1,000), geb_deep (fast frames of 4,096, 8 in flight
             a connection), shm_deep (string frames of 4,096 over the shm
             lane, folded in the server, as before the native hasher),
             unix_deep (those string frames over the same unix socket
             with no lane: what the lane's reader thread costs or saves),
             shm_fast (fast frames of 4,096 over the lane: the lane once
             the fold is gone), edge_http (16 callers posting JSON of
             1,000 to the edge, which sends fast frames: edge_fast_items
             rises by the window's items);
             each with its mean device batch, stage means, shed share,
             device span from CUDA events around each decide, and its
             launches balanced against decides and chunks; SIGTERM and
             its drain (edge and geb first); then a checked leg of 24
             frames (fast, string, legacy, traced, a chained item) into an
             in-process node of the same config on the card and on the
             CPU under one pinned clock, answers byte-identical, the
             chained item decided (no error, its leaf's limit);
10. chain    the two-tier engine: 2 decides of 8,192 chains (32,768 rows)
             held against the CPU (responses, stats, store and sketch
             bytes; the sketch never written), 20 timed (chains/s, device
             rows/s, batch ms median and p99, host prep, device span
             share, refusal share by refusing level); no partial debit:
             in a fresh window, 32 chains whose leaves are then spent and
             8,160 zipf chains in one batch, the store read before and
             after (snapshot_read), every key's remaining down by exactly
             its admitted chains' hits, refusals at the tenant and the
             leaf; then an in-process node (the daemon's build) and a
             10 s window of GEBC frames of 256 chains from 8 callers in a
             client process (--geb-window chain) into its GEB door:
             Instance -> chain lane -> TorchBackend.decide_chain, no error
             answer, launches balanced, chains/s, host ms a flush outside
             the engine (the expansion and collapse), device span share;
11. durability  (a) the two-tier engine filled with 2^20 live windows by
             decides of 32,768 distinct keys (a quarter each token, leaky,
             sliding, GCRA; an eighth then spent OVER, its token windows
             sticky): export_windows on the card (ms, bytes copied off it)
             field for field against a CPU engine given the same store,
             write_checkpoint (s, MiB on disk), read_checkpoint (s), a
             restore into a fresh card engine through the checkpoint
             manager's lane path (32 install chunks, one writeback launch
             each; s), a flat repartition (s), the restored and
             repartitioned exports equal to the original's, and a checked
             batch of 32,768 over the restored keys identical on the
             original, the restored and a CPU engine restored from the same
             files; time to recover = read + install. Cut: 2^20 live
             windows of the store's 16.8M entries. (b) a full-fleet
             restart: a Server of the deployment with GUBER_CHECKPOINT_DIR
             and GUBER_CHECKPOINT_INTERVAL_MS=250, 64 canaries (all four
             algorithms) driven OVER through gRPC, one flush, the drain
             (the final checkpoint), a second Server on the same directory:
             every canary OVER, restored_windows_total and
             restore_lag_seconds on /metrics, seconds from stop to serving,
             and the export's stall of the submit thread. (c) three card
             nodes of a LocalCluster with GUBER_REPLICATION=1,
             GUBER_RESCALE=1, GUBER_REPLICATION_SYNC_WAIT_MS=50: 96 token
             canaries driven OVER at their owners, one replication sync,
             one owner taken out of the others' ring (each of its canaries
             answers OVER at its successor from the standby snapshot,
             metadata replicated=true), then a fourth node joins and the
             rescale hands it the windows it now owns (each OVER at its
             door); no canary answer under the limit anywhere;
12. workloads  (a) the port's cli/bench_serving scenarios in this
             process on the card, each through its own parser at its
             deployment's flags with 1-2 s windows: zipf10m (BASELINE
             config 4: --depths 32768 --keys 10000000 --store-mib 1024
             --group 4096; its mean device batch beside the rung),
             zipf100m --rounds 2 (the two-tier deployment paired with its
             exact baseline, then its tail-error phase, whose dicts must
             equal the same calls on the CPU), key-churn, shed (four
             shares), flash-crowd --algorithm sliding, mixed-tenant-zipf
             --chain-depth 3, gcra-vs-token, the reference suite on
             three card nodes (--backend tpu --nodes 3), and the same
             cluster with the compiled edge in front of node 0, its
             batched gRPC row (--edge --edge-only: fed single-item
             requests by 16 callers, the edge stops sending frames on a
             gVisor host; PERF.md §6); each scenario's launches must equal the
             decides, chunks and warmups of every engine it built. (b)
             three `python -m gubernator_tpu_torch.cli.daemon` processes,
             each the serving phase's deployment, on static peers with
             their own GEB doors and chains on, driven for 5 s a leg by
             the port's cli/loadgen in a process of its own: gRPC frames
             of 1,000 to node 0 at an over-limit share of 0.9 (forwarding),
             fast GEB frames routed by owner (--ring-route 1, a cold key
             space of 262,144) and chained GEB frames (--chain-depth 3,
             share 0.5); each leg 0 errors (the loadgen counts failed
             calls; an item answered with an error is no refusal, so errors
             on hot keys pull the share down), its over-limit share within
             [share - 0.02, share + 0.001], the transport it asked for, each
             daemon's launches over the leg equal to its decides and chunks
             (/v1/debug/stats), and forwarded RPCs on nodes 1-2 in leg 1;
             decisions/s a leg beside the doors phase's one daemon and the
             cluster phase's one-loop cluster;
13. discovery  (a) three daemons of the exact-tier deployment
             (GUBER_BACKEND=tpu, GUBER_SKETCH=0, GUBER_STORE_MIB=1024: an
             int32[2^21, 128] store, 1 GiB a daemon) with no peer list,
             registered through the port's fake etcd (cli/fake_etcd.py, in
             this process, real gRPC): every /v1/HealthCheck reads
             peerCount 3; 4,096 keys sent through each node, the owner each
             answer names (a forwarded answer's `owner` metadata, else the
             node) the same on every node and in the ring built from the
             peer list; node 2's SIGTERM (its drain deletes its etcd key)
             takes the others to peerCount 2 and its restart back to 3,
             each within 10 s (the seconds printed), then a second pass of
             keys; every drain exits 0 and leaves etcd empty; (c) each
             daemon's launches over each pass equal its decides and chunks
             (/v1/debug/stats); (b) the port's chaos soak
             (cli/chaos_soak.py --backend tpu) in its three modes at the
             JAX tests' lengths (kill 15 s, rolling 12 s, restore 12 s),
             each three such daemons in processes of their own, each mode's
             JSON on a line, held to tests/test_chaos_soak.py's gates
             (error rate < 0.05, no in-flight loss, recovery within 2
             cooldowns + 1 s, faults injected, 0 canary under-admissions
             and > 30 over-limit samples, three drains exiting 0 with keys
             moved and the handoff lag within its bound, every restore
             cycle restoring windows);
14. kernels  the contract line over every kernel of the path.

The writeback kernel's launch count is set to 0 before each in-process
path (each durability leg, each workloads scenario) and read after it (the copy floor's and the ablation's are set to 0
before the first path and read after the last: they run on none, so they
must stay 0); each must equal that path's decides plus
window-install (and, in the cluster, gossip-charge) chunks, plus, in the
durability legs (b) and (c) and the workloads scenarios, two launches a
ladder rung for each engine warmup (one decide and one install a rung). A
daemon's count lives in its own process: it is read from /v1/debug/stats
just before and just after the doors window (and each workloads leg), and
the difference must equal
the window's decides plus install and gossip chunks, read the same way
(the discovery phase's daemons likewise, over each of its traffic passes).
Every window requires every answer to be a decision: one per-item error
(a failed forward, an open breaker) fails the run.
Prints the card's name and power limit (nvidia-smi) on a line of its own
and, last, {"ok": true, "device": {...}}. Exits non-zero, printing no
result, if there is no CUDA device, if the port is not importable, or if
any phase fails. Imports nothing of JAX or of gubernator_tpu.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# the repo's key streams (the port's copy of cli/keystreams.py; numpy only)
from gubernator_tpu_torch.cli import keystreams

# H100 SXM data sheet: HBM3 at 3.35 TB/s (the roofline for bytes)
HBM_BYTES_PER_S = 3.35e12
T0 = 1_700_000_000_000

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def zipf_hashes(n: int, seed: int = 42, key_space: int = KEY_SPACE) -> np.ndarray:
    return keystreams.zipf_pool(key_space, n, np.random.default_rng(seed))


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
    from gubernator_tpu_torch.cli.ablate_writeback import CALLS, run_ms, spin_up
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
        bytes_mean=mean_bytes, sets=len(sets), calls_per_run=CALLS,
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


#: the copy floor's shapes: scripts/bench_hbm.py's store (16 MiB, which
#: sits in the H100's 50 MB L2), and each store the writeback runs on
FLOOR_SHAPES = {
    "16m": ("16 MiB: scripts/bench_hbm.py's int32[32768, 128], in the 50 MB L2", 32768),
    "512m": ("512 MiB: the two-tier store, int32[2^20, 128]", 1 << 20),
    "1g": ("1 GiB: the exact store, int32[2^21, 128]", 1 << 21),
}


def copy_floor_cases(cyc: float) -> dict:
    """The copy-floor kernel (x += 1 over int32[rows, 128], in place)
    against its plain version, bit for bit, then ms / plain_ms /
    library_ms per call of a run of back-to-back calls at each shape:
    the bytes/s a pass over the store reaches on this card."""
    from gubernator_tpu_torch.cli.ablate_writeback import run_ms, spin_up
    from gubernator_tpu_torch.core.writeback import add_one, add_one_plain

    out = {}
    for key, (name, rows) in FLOOR_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(rows)
        x = torch.randint(-(2**31), 2**31 - 1, (rows, 128), dtype=torch.int32,
                          device="cuda", generator=gen)
        want = add_one_plain(x.clone())
        got = add_one(x.clone())
        torch.cuda.synchronize()
        max_abs_err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            fail(f"copy floor {key}: add_one disagrees with add_one_plain")
        del got, want
        fns = dict(ms=[lambda: add_one(x)], plain_ms=[lambda: add_one_plain(x)],
                   library_ms=[lambda: x.add_(1)])
        spin_up()
        samples = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
            for k in order:
                samples[k].append(run_ms(fns[k], cyc))
        times = {k: statistics.median(v) for k, v in samples.items()}
        nbytes = 2 * x.numel() * 4  # every int32 read once and written once
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the floor is the fastest measured pass, whichever code made it
        fastest = min(times, key=times.get)
        out[key] = dict(shape=name, rows=rows, bytes=nbytes, max_abs_err=max_abs_err,
                        **times, ms_samples=samples["ms"], bound_ms=bound_ms,
                        bound_by="bytes", share_of_bound=bound_ms / times["ms"],
                        vs_library=times["ms"] / times["library_ms"],
                        bytes_per_s=nbytes / (times["ms"] / 1e3),
                        plain_bytes_per_s=nbytes / (times["plain_ms"] / 1e3),
                        floor_bytes_per_s=nbytes / (times[fastest] / 1e3),
                        floor_by=dict(ms="add_one", plain_ms="add_one_plain",
                                      library_ms="x.add_(1)")[fastest])
        del x, fns
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def numpy_twins():
    """The engine, the merge and TorchEngine on their numpy twins: no
    native library for the duration."""
    import gubernator_tpu_torch.core.engine as e
    import gubernator_tpu_torch.parallel.sharded as s
    import gubernator_tpu_torch.serve.prep as p

    saved = [(m, m._native) for m in (e, s, p)]
    for m, _ in saved:
        m._native = lambda: None
    try:
        yield
    finally:
        for m, f in saved:
            m._native = f


def call_us(fn, reps: int = 25) -> float:
    """Median host microseconds of one call (the host's clock alone)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def hash_phase(card: str, slots: int) -> dict:
    """The native hasher and prep against the port's numpy twins: the
    XXH64 vectors, byte identity at one zipf100m batch, and host us a
    call of each, native and numpy, on this host."""
    from gubernator_tpu_torch.core import engine as eng
    from gubernator_tpu_torch.core import hashing
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.core.store import StoreConfig
    from gubernator_tpu_torch.native import load_hashlib
    from gubernator_tpu_torch.parallel.sharded import TorchEngine
    from gubernator_tpu_torch.serve import prep

    hn = load_hashlib()
    vectors = [int(x) for x in hn.hash_batch_seed(["", "a", "abc"], 0)]
    if vectors != [0xEF46DB3751D8E999, 0xD24EC4F1A98C6E5B, 0x44BC2CF5AD770999] or int(
            hn.hash_batch_seed(["0123456789abcdef" * 2 + "0123456789"], 7)[0]
    ) != 0x9CDB6129259B938E:
        fail(f"hash: XXH64 vectors {vectors}")
    rng = np.random.default_rng(21)
    ids = keystreams.zipf_ids(KEY_SPACE_100M, DEPTH, rng)
    kh = keystreams.hash_ids(ids)
    ones = np.ones(DEPTH, np.int64)
    batch = dict(key_hash=kh, hits=ones, limit=ones * LIMIT, duration=ones * DURATION_100M,
                 algo=rng.integers(0, 4, DEPTH).astype(np.int32),
                 gnp=rng.random(DEPTH) < 0.05)
    groups = [{k: v[i * GROUP:(i + 1) * GROUP] for k, v in batch.items()}
              for i in range(DEPTH // GROUP)]
    keys = [f"geb_zipf_{i}" for i in ids[:GROUP]]
    e = TorchEngine(StoreConfig(rows=1, slots=slots), buckets=buckets_for_limit(DEPTH),
                    device="cpu")

    def same(a, b) -> bool:
        if isinstance(a, dict):  # a native run also carries its "_addrs"
            keys = a.keys() - {"_addrs"}
            return keys == b.keys() - {"_addrs"} and all(same(a[k], b[k]) for k in keys)
        if isinstance(a, tuple):  # BatchRequest / BatchGroups
            return all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    runs = [eng.prep_run_single(g, slots) for g in groups]
    native = dict(presort=hn.presort(kh, slots), prep_run=eng.prep_run_single(batch, slots),
                  merge=prep.merge_runs(runs), merge_prepped=e.merge_prepped(runs))
    us = dict(hash_batch=call_us(lambda: hashing.slot_hash_batch(keys)),
              presort=call_us(lambda: eng._presort(kh, slots)),
              prep_run=call_us(lambda: eng.prep_run_single(groups[0], slots)),
              merge=call_us(lambda: e.merge_prepped(runs)))
    with numpy_twins():
        runs_np = [eng.prep_run_single(g, slots) for g in groups]
        twin = dict(presort=eng._np_presort(kh, slots),
                    prep_run=eng.prep_run_single(batch, slots),
                    merge=prep.merge_runs(runs_np), merge_prepped=e.merge_prepped(runs_np))
        us_np = dict(hash_batch=call_us(lambda: hashing._slot_hash_batch_py(keys), 5),
                     presort=call_us(lambda: eng._presort(kh, slots)),
                     prep_run=call_us(lambda: eng.prep_run_single(groups[0], slots)),
                     merge=call_us(lambda: e.merge_prepped(runs_np)))
    identical = {k: same(native[k], twin[k]) for k in native}
    if not all(identical.values()):
        fail(f"hash: the native prep differs from its numpy twin: {identical}")
    out = dict(phase="hash", card=card, xxh64=hashing.using_native_hash(),
               prep_threads=hn.prep_threads(), rows=DEPTH, slots=slots,
               identical=identical, host_us=us, numpy_host_us=us_np,
               numpy_over_native={k: us_np[k] / us[k] for k in us},
               calls=dict(hash_batch=f"{GROUP} keys", presort=f"{DEPTH} rows",
                          prep_run=f"{GROUP} rows", merge=f"{DEPTH // GROUP} runs of {GROUP}"))
    emit(out)
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
        eng.decide_arrays(keystreams.hash_ids(np.arange(c * DEPTH, (c + 1) * DEPTH)), *tok, now)
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
    expired = keystreams.hash_ids(np.arange(EXPIRED_PREFILL * DEPTH))
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
SERVING_ENV = {  # cli/bench_serving.py run_zipf100m's conf_for (both packages)
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
                dict(tok, key_hash=keystreams.hash_ids(np.arange(c * GROUP, (c + 1) * GROUP))))
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
    # the submit thread's merge a batch (the native merge)
    window["merge_ms"] = window["stages"].get("merge", {}).get("mean_ms")
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


def spawn_daemon(env: dict, root: str) -> tuple:
    """`python -m gubernator_tpu_torch.cli.daemon` with `env`, its output
    gathered by a reader thread; returns (process, log lines, reader)."""
    proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.cli.daemon"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    log: list = []
    reader = threading.Thread(target=lambda: log.extend(proc.stdout), daemon=True)
    reader.start()
    return proc, log, reader


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
        ids = keystreams.zipf_ids(KEY_SPACE_100M, RPC_ITEMS, rng)
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


def client_process(args: list, seconds: float, what: str) -> dict:
    """This script with `args` (--rpc-window or --geb-window) in a client
    process of its own, so that the callers' encode and decode leave this
    process's interpreter and event loop; its one JSON line."""
    import os

    here = os.path.abspath(__file__)
    r = subprocess.run([sys.executable, here, *args], cwd=os.path.dirname(here),
                       capture_output=True, text=True, timeout=seconds + 300)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        fail(f"the client process of {what} exited {r.returncode}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def client_window(target: str, seed: int, name: str, seconds: float) -> dict:
    """rpc_window in a client process of its own (--rpc-window)."""
    return client_process(["--rpc-window", target, str(seconds), str(seed), name],
                          seconds, f"the window against {target}")


def quiet_stats(base: str, what: str = "doors") -> dict:
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
    fail(f"{what}: /v1/debug/stats did not settle: {key(prev)}")


def doors_path(card: str) -> dict:
    """`python -m gubernator_tpu_torch.cli.daemon` as a subprocess with the
    serving phase's zipf100m env: boot checks, a limit-2 walk through gRPC
    and through the HTTP gateway, a timed window of RPCs, /metrics, then
    SIGTERM and its drain."""
    import asyncio
    import os
    import signal

    from gubernator_tpu_torch.api.types import RateLimitReq, Status
    from gubernator_tpu_torch.client import V1Client

    g, h = free_ports(2)
    target, base = f"127.0.0.1:{g}", f"http://127.0.0.1:{h}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **SERVING_ENV)
    env.update(GUBER_GRPC_ADDRESS=target, GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    proc, log, reader = spawn_daemon(env, root)

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


def _ring_routed_reqs(types, rng) -> list:
    """CLUSTER_CHECKED_RPCS // 2 request lists of BATCHING items over
    CLUSTER_KEYS ids of their own, each key at most once in a list, all
    four algorithms, hits-0 peeks among them: the fast frames' traffic."""
    out = []
    for _ in range(CLUSTER_CHECKED_RPCS // 2):
        n = int(rng.integers(200, RPC_ITEMS + 1))
        ks = rng.choice(CLUSTER_KEYS, n, replace=False)
        out.append([types.RateLimitReq(
            name="cluster", unique_key=f"ring{k}", hits=int(h), limit=(2, 10, 1000)[k % 3],
            duration=(1000, 60_000, 600_000)[k % 5 % 3], algorithm=types.Algorithm(k % 4))
            for k, h in zip(ks.tolist(), rng.choice([0, 1, 1, 2, 5], n).tolist())])
    return out


def _cluster_leg(cluster, types, reqs_list, pinned, geb_port: int) -> tuple:
    """The checked requests through node 0's gRPC door, one at a time
    under the pinned clock, GLOBAL settled after each; then one hits-0
    GLOBAL peek of every GLOBAL key at every node; then the ring-routed
    leg: a GebClient with ring_route on node 0's GEB door sends each
    request's fast frames to each key's owner door. Returns (the answers
    as tuples, the peeks per node, the peek requests, the ring-routed
    answers)."""
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.client_geb import GebClient

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
    ring = []
    with GebClient(f"127.0.0.1:{geb_port}", mode="fast", ring_route=True, shm="off",
                   timeout=120) as gc:
        for reqs in _ring_routed_reqs(types, np.random.default_rng(29)):
            pinned[0] += int(rng.choice([0, 1, 7, 300, 61_000]))
            ring.append([(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
                         for r in gc.get_rate_limits(reqs, timeout=120)])
        st = gc.stats()
    if not st["ring_routed"] or st["downgrades"] or not st["use_fast"]:
        fail(f"cluster: the GEB client did not route fast frames by the ring: {st}")
    return answers, peeks, peek, ring


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
    gports = free_ports(CLUSTER_NODES)  # each node's GEB door
    # the three nodes share this process's interpreter and one event loop,
    # so a forward waits behind every node's host work, not its owner's
    # alone: the peer and gossip deadlines rise from the reference's
    # 500 ms, or the harness itself would trip the breakers. The GLOBAL
    # loops park (their 600 s window outlasts the phase): the checked leg
    # runs their rounds by explicit calls, so both clusters batch alike.
    env = dict(SERVING_ENV, GUBER_PEER_TIMEOUT_MS="10000", GUBER_GLOBAL_TIMEOUT_MS="10000",
               GUBER_GLOBAL_SYNC_WAIT_MS="600000")
    gpu = LocalCluster(addrs, env=env, geb_ports=gports)
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
        got, got_peeks, peek, got_ring = _cluster_leg(gpu, types, reqs_list, pinned,
                                                      gports[0])
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

    cpu = LocalCluster(addrs, env=env, backend_factory=cpu_backend, geb_ports=gports)
    cpu.start(timeout=BOOT_S)
    try:
        for s, ep in zip(cpu.servers, epochs):
            s.backend.engine.clock.epoch = ep
            cpu.run(s.instance.promoter.stop())
        pinned[0] = p0
        types.millisecond_now = lambda: pinned[0]
        for s in cpu.servers:
            s.instance.shed.now_fn = types.millisecond_now
        want, want_peeks, _, want_ring = _cluster_leg(cpu, types, reqs_list, pinned,
                                                      gports[0])
    finally:
        types.millisecond_now = real_now
        cpu.stop()
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"cluster checked rpc {i} item {j}: card {a[j]}, cpu {b[j]}")
    if got_peeks != want_peeks:
        fail("cluster: the GLOBAL peeks differ from the CPU cluster's")
    for i, (a, b) in enumerate(zip(got_ring, want_ring)):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"cluster ring-routed request {i} item {j}: card {a[j]}, cpu {b[j]}")
    if any(x[4] for a in got_ring for x in a):
        fail("cluster: a ring-routed answer is an error")
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
                   global_non_token_answers_unlike_owner=differ[0], cpu_identical=True,
                   ring_routed_requests=len(got_ring),
                   ring_routed_items=sum(len(a) for a in got_ring))
    emit(dict(phase="check", path="cluster", **checked))
    window.update(forwarded_share=fwd_share)
    emit(dict(phase="window", path="cluster", card=card, **window))
    out = dict(nodes=CLUSTER_NODES, addresses=addrs, boot_s=boot_s, bytes_on_card=on_card,
               decides=decides, chunks=chunks, kernel_launches=launches,
               per_node_stats=per_node)
    emit(dict(phase="main", path="cluster", card=card, **out))
    return dict(launches=launches, decides=decides, chunks=chunks, window=window)


# -- the geb phase: the GEB frame doors and the compiled edge ----------------

GEB_CALLERS = 16  # connections (HTTP callers for edge_http) in a geb window
GEB_ITEMS = 1000  # items a frame (or a JSON request) carries in geb_1000, edge_http
GEB_DEEP_ITEMS = 4096  # items a frame carries in geb_deep and shm_deep
GEB_DEEP_INFLIGHT = 8  # frames in flight per connection in the deep windows
GEB_POOL = 24  # prebuilt frames (or JSON bodies) the callers cycle through
GEB_CHECKED_FRAMES = 24
GEB_WINDOWS = ("geb_1000", "geb_deep", "shm_deep", "unix_deep", "shm_fast", "edge_http")
GEB_WINDOW_S = 5.0  # each geb window (10 s before the chain phase took its time)
SHM_WINDOWS = ("shm_deep", "shm_fast")  # the windows over the shm lane
STRING_WINDOWS = ("shm_deep", "unix_deep")  # string frames, folded in the server

def _zipf_reqs(types, rng, n: int, name: str) -> list:
    """n request objects of zipf(1.2) ids over 100M: token, hits 1, limit
    1000, 600 s (the doors window's traffic)."""
    ids = keystreams.zipf_ids(KEY_SPACE_100M, n, rng)
    return [types.RateLimitReq(name=name, unique_key=str(int(i)), hits=HITS, limit=LIMIT,
                               duration=DURATION_100M) for i in ids.tolist()]


async def _geb_open(endpoint: str):
    """(reader, writer, hello) of a fresh GEB connection to `endpoint`
    (host:port, or a unix socket's path), the hello read by client_geb."""
    import asyncio

    from gubernator_tpu_torch import client_geb as cg

    kind, addr = cg.parse_endpoint(endpoint, "GEB endpoint")
    if kind == "unix":
        reader, writer = await asyncio.open_unix_connection(addr)
    else:
        reader, writer = await asyncio.open_connection(*addr)
    return reader, writer, await cg.read_hello(reader)


async def _geb_hello(endpoint: str):
    """The hello a fresh connection to `endpoint` reads."""
    _reader, writer, hello = await _geb_open(endpoint)
    writer.close()
    return hello


def _answer_dtype(magic: int, what: str):
    """The record dtype of a windowed answer frame, the bridge's own:
    the load loop views answers with numpy, no object per item, so the
    client process does not bound the window."""
    from gubernator_tpu_torch import client_geb as cg
    from gubernator_tpu_torch.serve import edge_bridge as eb

    if magic == cg.MAGIC_WFAST_RESP:
        return eb._fast_dtypes()[1]
    if magic == cg.MAGIC_WRESP:  # all-decision string records: elen = olen = 0
        return eb._string_resp_dtype()
    raise RuntimeError(f"{what}: an answer with magic {magic:#x}")


def _check_answers(magic: int, n: int, body: bytes, what: str, limits=(LIMIT,)):
    """A windowed answer frame's records: a decision each, no error, one
    of the window's limits (a chained request answers with its refusing
    level's, else its leaf's), remaining in range; returns the records.
    Raises RuntimeError otherwise."""
    rec = np.frombuffer(body, _answer_dtype(magic, what), count=n)
    if "elen" in rec.dtype.names and (rec["elen"].any() or rec["olen"].any()):
        raise RuntimeError(f"{what}: an error answer")
    if ((rec["status"] > 1).any() or not np.isin(rec["limit"], limits).all()
            or (rec["remaining"] < 0).any() or (rec["remaining"] > rec["limit"]).any()):
        raise RuntimeError(f"{what}: a malformed answer")
    return rec


async def _frame_conn(kind: str, target: str, frames: list, stop_at: float,
                      inflight: int, out: dict) -> None:
    """One GEB connection (for shm_deep with the shm lane mapped, as
    client_geb maps it) keeping up to `inflight` frames out: each a
    prebuilt frame with a fresh id, answers matched by id, checked and
    counted."""
    import asyncio

    from gubernator_tpu_torch import client_geb as cg

    reader, writer, _hello = await _geb_open(target)
    loop = asyncio.get_running_loop()
    pending: dict = {}

    def settle(fid, result):
        fut = pending.pop(fid, None)
        if fut is not None and not fut.done():
            fut.set_result(result)

    def fail_all(exc):
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)
        pending.clear()

    lane, reader_task = None, None
    if kind in SHM_WINDOWS:
        def on_frame(data):
            magic, n = struct.unpack_from("<II", data, 0)
            if magic == cg.MAGIC_STALE:
                fail_all(RuntimeError(f"{kind}: a GEBR refusal (id {n:#x})"))
                return
            settle(struct.unpack_from("<I", data, 8)[0], (magic, n, data[12:]))

        lane = await cg.negotiate_shm(
            reader, writer, on_frame,
            lambda exc: fail_all(RuntimeError(f"{kind}: the lane tore: {exc}")))
        if lane is None:
            raise RuntimeError(f"{kind}: the bridge refused the lane")
        if max(len(f) for f in frames) + 4 > lane.frame_bound:
            raise RuntimeError(f"{kind}: a frame outgrows the lane")
    else:
        async def read_loop():
            try:
                while True:
                    magic, n = struct.unpack("<II", await reader.readexactly(8))
                    if magic == cg.MAGIC_STALE:
                        raise RuntimeError(f"{kind}: a GEBR refusal (id {n:#x})")
                    (fid,) = struct.unpack("<I", await reader.readexactly(4))
                    size = _answer_dtype(magic, kind).itemsize * n
                    settle(fid, (magic, n, await reader.readexactly(size)))
            except Exception as e:
                fail_all(e if isinstance(e, RuntimeError)
                         else RuntimeError(f"{kind}: the connection ended: {e!r}"))

        reader_task = asyncio.ensure_future(read_loop())
    ids = [0]

    async def slot(w: int):
        i = w
        while time.monotonic() < stop_at:
            frame = frames[i % len(frames)]
            i += inflight
            ids[0] += 1
            fid = ids[0]
            buf = frame[:8] + struct.pack("<I", fid) + frame[12:]
            fut = loop.create_future()
            pending[fid] = fut
            t0 = time.perf_counter()
            if lane is not None:
                while not lane.try_send(buf):  # ring full: wait for the server
                    out["ring_full"] += 1
                    await asyncio.sleep(0.0005)
            else:
                writer.write(buf)
                await writer.drain()
            magic, n, body = await fut
            out["lat"].append((time.perf_counter() - t0) * 1e3)
            if kind == "chain":
                rec = _check_answers(magic, n, body, kind, CHAIN_LEVEL_LIMITS)
                for level, lim in zip(CHAIN_LEVELS, CHAIN_LEVEL_LIMITS):
                    out["refused_by_level"][level] += int(
                        ((rec["status"] == 1) & (rec["limit"] == lim)).sum())
            else:
                _check_answers(magic, n, body, kind)
            out["items"] += n
            out["frames"] += 1

    try:
        await asyncio.gather(*[slot(w) for w in range(inflight)])
    finally:
        if lane is not None:
            lane.close()
        if reader_task is not None:
            reader_task.cancel()
        writer.close()


async def _http_caller(sess, url: str, bodies: list, w: int, stop_at: float, out: dict):
    """One edge_http caller: JSON GetRateLimits of GEB_ITEMS items, one
    awaited at a time; every answer checked."""
    i = w * 5
    while time.monotonic() < stop_at:
        body = bodies[i % len(bodies)]
        i += 1
        t0 = time.perf_counter()
        async with sess.post(url, data=body,
                             headers={"Content-Type": "application/json"}) as r:
            raw = await r.read()
            if r.status != 200:
                raise RuntimeError(f"edge_http: HTTP {r.status}: {raw[:200]!r}")
        out["lat"].append((time.perf_counter() - t0) * 1e3)
        rs = json.loads(raw)["responses"]
        if len(rs) != GEB_ITEMS or any(x["error"] for x in rs):
            raise RuntimeError(f"edge_http: {len(rs)} answers, or an error answer")
        if any(x["limit"] != str(LIMIT) or not 0 <= int(x["remaining"]) <= LIMIT for x in rs):
            raise RuntimeError("edge_http: a malformed answer")
        out["items"] += len(rs)
        out["frames"] += 1


def geb_window_main(argv: list) -> int:
    """`chip_smoke.py --geb-window KIND TARGET SECONDS SEED`: one geb
    window's callers in this process, against TARGET (host:port, or the
    edge bridge's unix socket for shm_deep, unix_deep and shm_fast, or the
    edge's HTTP port for edge_http); one JSON line. Needs no card."""
    import asyncio

    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch import client_geb as cg

    kind, target, seconds, seed = argv
    seconds = float(seconds)
    rng = np.random.default_rng(int(seed))
    out = dict(lat=[], items=0, frames=0, ring_full=0)
    if kind == "edge_http":
        bodies = [json.dumps({"requests": [
            {"name": "edge_zipf", "uniqueKey": r.unique_key, "hits": HITS, "limit": LIMIT,
             "duration": DURATION_100M} for r in _zipf_reqs(types, rng, GEB_ITEMS, "x")]}
        ).encode() for _ in range(GEB_POOL)]

        async def run():
            import aiohttp

            stop_at = time.monotonic() + seconds
            async with aiohttp.ClientSession() as sess:
                await asyncio.gather(*[
                    _http_caller(sess, f"http://{target}/v1/GetRateLimits", bodies, w,
                                 stop_at, out) for w in range(GEB_CALLERS)])
        framing, inflight, items, callers = "json", 1, GEB_ITEMS, GEB_CALLERS
    else:
        inflight, items = ((1, GEB_ITEMS) if kind == "geb_1000"
                           else (1, CHAIN_GROUP) if kind == "chain"
                           else (GEB_DEEP_INFLIGHT, GEB_DEEP_ITEMS))
        callers = CHAIN_CALLERS if kind == "chain" else GEB_CALLERS

        h = asyncio.run(_geb_hello(target))
        if inflight > h.window:
            raise SystemExit(f"{kind}: {inflight} frames in flight exceed the window {h.window}")
        if kind in SHM_WINDOWS and not h.shm:
            raise SystemExit(f"{kind}: the unix socket's hello offers no shm lane")
        if kind == "chain" and not h.chain:
            raise SystemExit("chain: the hello offers no quota-chain frames")
        fast = kind not in STRING_WINDOWS + ("chain",)
        if fast and not (h.fast and h.xxh64 == cg.client_hash_is_native()):
            raise SystemExit(f"{kind}: the hello offers no fast frames this client can hash")
        if kind == "chain":
            out["refused_by_level"] = dict.fromkeys(CHAIN_LEVELS, 0)
        frames = [cg.build_frame(chain_reqs(types, rng, items) if kind == "chain"
                                 else _zipf_reqs(types, rng, items, "geb_zipf"), fast=fast,
                                 windowed=True, frame_id=0, ring_hash=h.ring_hash)[0]
                  for _ in range(GEB_POOL)]
        framing = ("chain GEBC" if kind == "chain" else "fast GEB7" if fast
                   else "string GEB2")

        async def run():
            stop_at = time.monotonic() + seconds
            await asyncio.gather(*[_frame_conn(kind, target, frames, stop_at, inflight, out)
                                   for _ in range(callers)])
    t0 = time.monotonic()
    asyncio.run(run())
    elapsed = time.monotonic() - t0
    lat = out.pop("lat")
    print(json.dumps(dict(
        kind=kind, framing=framing, decisions_per_s=out["items"] / elapsed, seconds=elapsed,
        callers=callers, inflight_per_conn=inflight, items_per_frame=items, errors=0,
        frame_ms_p50=float(np.percentile(lat, 50)), frame_ms_p99=float(np.percentile(lat, 99)),
        **out)), flush=True)
    return 0


def _walk_ok(rows) -> bool:
    """(status, remaining, reset_time) of a limit-2 key's three hits:
    1 -> 0 -> OVER_LIMIT with one reset_time."""
    return ([r[1] for r in rows] == [1, 0, 0] and [r[0] for r in rows] == [0, 0, 1]
            and len({r[2] for r in rows}) == 1)


def geb_path(card: str, edge_build_result: dict) -> dict:
    """The port's daemon with the frame doors (GEB door, /v1/geb, the edge
    bridge on a unix socket and on TCP, the shm lane) and the port's
    compiled edge in front of it: hello checks, walks through every door,
    one count shared by the edge and the fast door, the GEB_WINDOWS with
    their callers in a client process, and SIGTERM."""
    import asyncio
    import os
    import signal
    import socket
    import tempfile
    import urllib.request

    from gubernator_tpu_torch import client_geb as cg
    from gubernator_tpu_torch.api.types import RateLimitReq
    from gubernator_tpu_torch.client import V1Client

    edge_bin = edge_build_result.get("path")
    if edge_bin is None:
        fail(f"geb: the edge did not build: {edge_build_result.get('error')}")
    emit(dict(phase="build", path="geb", edge=os.path.basename(str(edge_bin)),
              seconds=edge_build_result["seconds"]))
    g, h, geb, etcp, eh, eg = free_ports(6)
    sock = os.path.join(tempfile.mkdtemp(prefix="guber-geb-"), "edge.sock")
    target, base = f"127.0.0.1:{g}", f"http://127.0.0.1:{h}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **SERVING_ENV)
    env.update(GUBER_GRPC_ADDRESS=target, GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}",
               GUBER_GEB_PORT=str(geb), GUBER_EDGE_SOCKET=sock,
               GUBER_EDGE_TCP=f"127.0.0.1:{etcp}",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    proc, log, reader = spawn_daemon(env, root)
    edge = None

    def died(what):
        for p in (edge, proc):
            if p is not None and p.poll() is None:
                p.kill()
        reader.join(5)
        sys.stderr.write("".join(log[-60:]))
        fail(f"geb: {what}")

    try:
        # the edge bridge opens last, after the warmup and every other door
        while not any("edge bridge listening on tcp" in ln for ln in log):
            if proc.poll() is not None:
                died(f"the daemon exited with {proc.returncode} during boot")
            if time.monotonic() - t0 > BOOT_S:
                died("the daemon did not open its doors in time")
            time.sleep(0.2)
        boot_s = time.monotonic() - t0
        edge = subprocess.Popen([str(edge_bin), "--listen", str(eh), "--grpc-listen", str(eg),
                                 "--backend", sock], stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        for port in (eh, eg):
            for _ in range(200):
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=1).close()
                    break
                except OSError:
                    if edge.poll() is not None:
                        died(f"the edge exited with {edge.returncode}")
                    time.sleep(0.1)
            else:
                died(f"the edge never listened on {port}")

        # hello checks
        with urllib.request.urlopen(base + "/v1/geb", timeout=30) as r:
            http_hello = cg.parse_hello_bytes(r.read())
        flags = dict(geb=asyncio.run(_geb_hello(f"127.0.0.1:{geb}")).flags,
                     http=http_hello.flags, edge_unix=asyncio.run(_geb_hello(sock)).flags,
                     edge_tcp=asyncio.run(_geb_hello(f"127.0.0.1:{etcp}")).flags)
        # every door offers fast frames hashed XXH64, the edge bridge too,
        # and quota-chain frames (GUBER_CHAINS is on by default)
        base_bits = (cg.HELLO_WINDOWED | cg.HELLO_TRACE | cg.HELLO_FAST | cg.HELLO_XXH64
                     | cg.HELLO_CHAIN)
        want = dict(geb=base_bits, http=base_bits, edge_unix=base_bits | cg.HELLO_SHM,
                    edge_tcp=base_bits)
        hello_ok = all((flags[k] & 0xFFFF) == want[k] for k in want)
        emit(dict(phase="hello", path="geb", ok=hello_ok, boot_s=boot_s,
                  flags={k: hex(v) for k, v in flags.items()},
                  window=flags["geb"] >> 16))
        if not hello_ok:
            died(f"hello flags {flags}, want (low 16 bits) {want}")

        # the walks: a limit-2 key through every door
        def req(key, hits=1, limit=2):
            return RateLimitReq(name="geb", unique_key=key, hits=hits, limit=limit,
                                duration=60_000)

        def rows(rs):
            return [(int(r.status), r.remaining, r.reset_time) for r in rs]

        walks, transports = {}, {}
        for name, endpoint, mode, shm in (("fast", f"127.0.0.1:{geb}", "fast", "off"),
                                          ("string", f"127.0.0.1:{geb}", "string", "off"),
                                          ("shm", f"unix:{sock}", "auto", "require")):
            with cg.GebClient(endpoint, mode=mode, shm=shm, timeout=60) as c:
                walks[name] = [rows(c.get_rate_limits([req(f"walk_{name}")]))[0]
                               for _ in range(3)]
                transports[name] = c.stats()

        async def http_walk():
            c = cg.AsyncHttpGebClient(base)
            try:
                return [rows(await c.get_rate_limits([req("walk_http")]))[0] for _ in range(3)]
            finally:
                await c.close()

        walks["http_geb"] = asyncio.run(http_walk())
        body = {"requests": [{"name": "geb", "uniqueKey": "walk_edge_json", "hits": 1,
                              "limit": 2, "duration": 60000}]}
        walks["edge_json"] = []
        for _ in range(3):
            st, b = http_json(f"http://127.0.0.1:{eh}/v1/GetRateLimits", body)
            x = b["responses"][0] if st == 200 else {}
            walks["edge_json"].append(({"UNDER_LIMIT": 0, "OVER_LIMIT": 1}.get(x.get("status")),
                                       int(x.get("remaining", -1)), x.get("resetTime")))
        with V1Client(f"127.0.0.1:{eg}") as c:
            walks["edge_grpc"] = [rows(c.get_rate_limits([req("walk_edge_grpc")], timeout=60))[0]
                                  for _ in range(3)]
        # one key, hits through the fast door and the edge's fast frames in
        # turn: one count
        shared = []
        m0 = http_text(base + "/metrics")
        with cg.GebClient(f"127.0.0.1:{geb}", mode="fast", shm="off", timeout=60) as c:
            for i in range(6):
                if i % 2:
                    st, b = http_json(f"http://127.0.0.1:{eh}/v1/GetRateLimits", {"requests": [
                        {"name": "geb", "uniqueKey": "shared", "hits": 1, "limit": 10,
                         "duration": 60000}]})
                    shared.append(int(b["responses"][0]["remaining"]))
                else:
                    shared.append(c.get_rate_limits([req("shared", limit=10)])[0].remaining)
        # edge_fast_items counts the fast items of every frame door: the
        # three through the GEB door and, now, the edge's three; none folded
        m1 = http_text(base + "/metrics")
        shared_items = {k: metric_value(m1, k) - metric_value(m0, k)
                        for k in ("edge_fast_items_total", "edge_folded_items_total")}
        walk_ok = (all(_walk_ok(w) for w in walks.values())
                   and transports["fast"]["use_fast"] and not transports["string"]["use_fast"]
                   and transports["shm"]["transport"] == "shm"
                   and transports["shm"]["frames_shm"] == 3
                   and shared == [9, 8, 7, 6, 5, 4]
                   and shared_items == {"edge_fast_items_total": 6,
                                        "edge_folded_items_total": 0})
        emit(dict(phase="walk", path="geb", ok=walk_ok, walks=walks, shared_count=shared,
                  shared_items=shared_items,
                  transports={k: {x: v[x] for x in ("transport", "use_fast", "frames_shm")}
                              for k, v in transports.items()}))
        if not walk_ok:
            died("a walk did not go 1 -> 0 -> OVER_LIMIT with one reset, or the edge and "
                 "the fast door counted one key apart, or the edge's hits were not fast")

        # the windows, each with its callers in a client process
        windows, launches = {}, 0
        targets = dict(geb_1000=f"127.0.0.1:{geb}", geb_deep=f"127.0.0.1:{geb}",
                       shm_deep=sock, unix_deep=sock, shm_fast=sock,
                       edge_http=f"127.0.0.1:{eh}")
        for seed, kind in enumerate(GEB_WINDOWS, start=40):
            s0 = quiet_stats(base)
            m0 = http_text(base + "/metrics")
            http_json(base + "/v1/debug/stages?reset=1")
            w = client_process(["--geb-window", kind, targets[kind], str(GEB_WINDOW_S),
                                str(seed)], GEB_WINDOW_S, f"the {kind} window")
            m1 = http_text(base + "/metrics")
            _, stages = http_json(base + "/v1/debug/stages")
            s1 = quiet_stats(base)
            rows_ = (metric_value(m1, "device_batch_size_sum")
                     - metric_value(m0, "device_batch_size_sum"))
            nb = (metric_value(m1, "device_batch_size_count")
                  - metric_value(m0, "device_batch_size_count"))
            wl = (s1["kernel_launches"]["writeback_add"]
                  - s0["kernel_launches"]["writeback_add"])
            decides = s1["backend"]["batches"] - s0["backend"]["batches"]
            chunks = sum(s1["engine_chunks"][k] - s0["engine_chunks"][k]
                         for k in ("install_chunks", "gossip_chunks"))
            span_ms = s1["device_span_ms"] - s0["device_span_ms"]
            counters = {k: metric_value(m1, k) - metric_value(m0, k) for k in (
                "edge_fast_items_total", "edge_folded_items_total", "geb_shm_frames_total")}
            if nb <= 0 or decides <= 0 or wl != decides + chunks:
                died(f"{kind}: writeback kernel launched {wl} times for {decides} decides + "
                     f"{chunks} install and gossip chunks ({nb} device batches in /metrics)")
            if kind in SHM_WINDOWS and counters["geb_shm_frames_total"] <= 0:
                died(f"{kind}: geb_shm_frames_total did not rise")
            # the edge pre-hashes XXH64 like the store: its items ride fast frames
            if kind == "edge_http" and (counters["edge_fast_items_total"] != w["items"]
                                        or counters["edge_folded_items_total"] != 0):
                died(f"edge_http: edge counters moved {counters} for {w['items']} items")
            st = stages["stages"]
            shed = stages.get("shed_cache") or {}
            w.update(device_batches=nb, mean_device_batch=rows_ / nb, kernel_launches=wl,
                     decides=decides, chunks=chunks, counters=counters,
                     merge_ms=st.get("merge", {}).get("mean_ms"),
                     dispatch_ms=st.get("dispatch", {}).get("mean_ms"),
                     shed_hits=shed.get("hits"), shed_share=(shed.get("hits", 0) / w["items"]),
                     device_span_ms=span_ms,
                     # the span counts the host's launch gaps inside each
                     # decide as busy: idle is at least this, not this
                     device_span_share=span_ms / (w["seconds"] * 1e3),
                     device_idle_lower_bound=1 - span_ms / (w["seconds"] * 1e3),
                     stages=st, stage_coverage=stages.get("coverage"))
            emit(dict(phase="window", path="geb", card=card, **w))
            windows[kind] = w
            launches += wl

        # SIGTERM: the frame doors drain first, then the rest
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(10)
        drained = next((ln for ln in log if "drained in" in ln), "")
        steps = ("edge", "geb", "grpc", "http", "global_flush", "batcher")
        if rc != 0 or not all(f"'{s}'" in drained for s in steps):
            died(f"SIGTERM: exit {rc}, drain line {drained.strip()!r}")
        emit(dict(phase="drain", path="geb", exit_code=rc, drain=drained.strip()))
    finally:
        for p in (edge, proc):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(30)
    return dict(windows=windows, launches=launches, boot_s=boot_s)


def _geb_checked_frames(types, rng, ring: int) -> list:
    """GEB_CHECKED_FRAMES request frames over 300 keys (duplicates inside a
    frame), all four algorithms, hits-0 peeks: windowed fast and string
    frames in turn, one legacy string frame, one traced frame and one
    chain frame with a chained item among plain ones."""
    from gubernator_tpu_torch import client_geb as cg
    from gubernator_tpu_torch.serve.tracing import TraceContext

    frames = []
    for i in range(GEB_CHECKED_FRAMES):
        n = int(rng.integers(50, 1000))
        ks = rng.integers(0, 300, n)
        reqs = [types.RateLimitReq(
            name="geb_checked", unique_key=f"k{k}", hits=int(h), limit=(2, 10, 1000)[k % 3],
            duration=(1000, 60_000, 600_000)[k % 5 % 3], algorithm=types.Algorithm(k % 4))
            for k, h in zip(ks.tolist(), rng.choice([0, 1, 1, 2, 5], n).tolist())]
        fast, windowed, ctx = i % 2 == 0, True, None
        if i == 7:
            fast, windowed = False, False  # legacy GEB1
        elif i == 9:
            ctx = TraceContext(0xABC, 0xDEF, True)  # GEBT
        elif i == 11:
            fast = False
            reqs[0] = types.RateLimitReq(
                name="geb_checked", unique_key="leaf", hits=1, limit=5, duration=60_000,
                chain=[types.ChainLevel(unique_key="head", limit=9, duration=60_000)])
        frames.append(cg.build_frame(reqs, fast=fast, windowed=windowed, frame_id=100 + i,
                                     ring_hash=ring, trace_ctx=ctx)[0])
    return frames


async def _send_frames(endpoint: str, frames: list) -> list:
    """Each frame on one GEB connection, one at a time; the answers'
    bytes, each read by its framing."""
    from gubernator_tpu_torch import client_geb as cg

    reader, writer, _hello = await _geb_open(endpoint)
    read = reader.readexactly
    try:
        out = []
        for f in frames:
            writer.write(f)
            await writer.drain()
            hdr = await read(8)
            magic, n = struct.unpack("<II", hdr)
            if magic in (cg.MAGIC_WRESP, cg.MAGIC_WFAST_RESP):
                hdr += await read(4)
            if magic in (cg.MAGIC_FAST_RESP, cg.MAGIC_WFAST_RESP):
                out.append(hdr + await read(25 * n))
                continue
            body = b""
            for _ in range(n):  # 25 fixed bytes, then error and owner strings
                body += await read(25)
                for _field in range(2):
                    ln = await read(2)
                    body += ln + await read(struct.unpack("<H", ln)[0])
            out.append(hdr + body)
        return out
    finally:
        writer.close()


def geb_checked_leg(card: str, writeback) -> dict:
    """GEB_CHECKED_FRAMES frames through the GEB door of an in-process node
    of the deployment on the card (a daemon's clock cannot be pinned, so
    the node runs here, built as the daemon builds it) and of the same
    node on the CPU, under one pinned clock: the answers' bytes must be
    identical."""
    import asyncio

    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch import client_geb as cg
    from gubernator_tpu_torch.cluster import LocalCluster
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.config import config_from_env

    g, geb = free_ports(2)
    addr = f"127.0.0.1:{g}"
    env = dict(SERVING_ENV, GUBER_GLOBAL_SYNC_WAIT_MS="600000")
    conf = config_from_env(dict(env))
    store, skc = conf.store_config(), conf.sketch_config()
    ladder = buckets_for_limit(conf.device_batch_limit)

    def cpu_backend():
        b = TorchBackend(store, buckets=ladder, sketch=skc, device="cpu")
        b.warmup = lambda: None  # nothing to load; the epoch is copied below
        return b

    real_now = types.millisecond_now
    answers, epoch, frames = {}, None, None
    for name, factory in (("card", None), ("cpu", cpu_backend)):
        c = LocalCluster([addr], env=env, backend_factory=factory, geb_ports=[geb])
        c.start(timeout=BOOT_S)
        try:
            s = c.servers[0]
            c.run(s.instance.promoter.stop())  # its ticks run by no one here
            eng = s.backend.engine
            if name == "card":
                if eng.device.type != "cuda":
                    fail("geb checked leg: the card node is not on the card")
                writeback.writeback_add.launches = 0  # count this leg only
                chunks0, b0 = eng.install_chunks + eng.gossip_chunks, s.backend.stats()["batches"]
            else:
                eng.clock.epoch = epoch
            pinned = [real_now() + 1] if name == "card" else [answers["t0"]]
            answers.setdefault("t0", pinned[0])
            types.millisecond_now = lambda: pinned[0]
            s.instance.shed.now_fn = types.millisecond_now
            if frames is None:
                ring = asyncio.run(_geb_hello(f"127.0.0.1:{geb}")).ring_hash
                frames = _geb_checked_frames(types, np.random.default_rng(31), ring)
            rng = np.random.default_rng(37)
            got = []
            for f in frames:
                pinned[0] += int(rng.choice([0, 1, 7, 300, 61_000]))
                got.extend(asyncio.run(_send_frames(f"127.0.0.1:{geb}", [f])))
            answers[name] = got
            if name == "card":
                epoch = eng.clock.epoch  # set by the warmup's decides at the latest
                launches = writeback.writeback_add.launches
                decides = s.backend.stats()["batches"] - b0
                chunks = eng.install_chunks + eng.gossip_chunks - chunks0
        finally:
            types.millisecond_now = real_now
            c.stop()
    torch.cuda.empty_cache()
    if launches != decides + chunks or launches == 0:
        fail(f"geb checked leg: writeback kernel launched {launches} times for {decides} "
             f"decides + {chunks} chunks")
    for i, (a, b) in enumerate(zip(answers["card"], answers["cpu"])):
        if a != b:
            fail(f"geb checked frame {i}: the card's answer differs from the CPU's")
    a11 = answers["card"][11]
    chained = cg.decode_string_body(a11[12:], struct.unpack_from("<I", a11, 4)[0])[0]
    if chained.error or chained.limit != 5:  # decided on the chain lane, answered by its leaf
        fail(f"geb checked leg: the chained item answered {chained}")
    items = sum(struct.unpack_from("<I", a, 4)[0] for a in answers["card"])
    out = dict(frames=len(frames), items=items, cpu_identical=True, launches=launches,
               decides=decides, chunks=chunks,
               chained_item=[int(chained.status), chained.limit, chained.remaining])
    emit(dict(phase="check", path="geb", card=card, **out))
    return out


# -- the chain phase: hierarchical quota chains at the zipf100m deployment --

# the mixed_tenant_zipf scenario (gubernator_tpu/cli/bench_serving.py:1355-1440)
CHAIN_LEVELS = ("global", "region", "tenant", "leaf")
CHAIN_LEVEL_LIMITS = (1 << 30, 1 << 24, 1200, 1 << 20)  # the leaf's last
CHAIN_DURATION = 60_000
CHAIN_TENANTS = 64
CHAIN_ROWS = len(CHAIN_LEVELS)  # device rows a chained request expands to
CHAINS_PER_DECIDE = DEPTH // CHAIN_ROWS  # 8,192 chains = 32,768 rows
CHAIN_CHECKED = 2  # engine decides held against the CPU
CHAIN_TIMED = 20
CHAIN_LEAF_REFUSALS = 32  # chains of the no-partial-debit batch whose leaf is spent
CHAIN_GROUP = 256  # chains a GEBC frame carries (the scenario's chain_group)
CHAIN_CALLERS = 8  # the scenario's workers


def chain_reqs(types, rng, n: int, name: str = "mtz") -> list:
    """n chained requests of the scenario: global -> region:{t%4} ->
    tenant:{t} above the leaf k:{t}:{0..2^14}, hits 1, 60 s."""
    lim = CHAIN_LEVEL_LIMITS
    return [types.RateLimitReq(
        name=name, unique_key=f"k:{t}:{int(rng.integers(1 << 14))}", hits=1, limit=lim[3],
        duration=CHAIN_DURATION,
        chain=[types.ChainLevel("global", lim[0], 0), types.ChainLevel(f"region:{t % 4}", lim[1], 0),
               types.ChainLevel(f"tenant:{t}", lim[2], 0)])
        for t in keystreams.tenant_zipf_ids(CHAIN_TENANTS, n, rng).tolist()]


def chain_rows(tenants, leaves, name: str = "mtz", leaf_limit: int = CHAIN_LEVEL_LIMITS[3]):
    """decide_chain_arrays' arguments for chains of the scenario's shape,
    one per (tenant, leaf key) pair, expanded as TorchBackend.decide_chain
    expands them: the levels shallow to deep, the leaf last, one chain id
    a request, every row routed by the head."""
    from gubernator_tpu_torch.core.hashing import slot_hash_batch

    keys = []
    for t, leaf in zip(tenants, leaves):
        keys += [f"{name}_global", f"{name}_region:{t % 4}", f"{name}_tenant:{t}",
                 f"{name}_{leaf}"]
    n = len(keys) // CHAIN_ROWS
    kh = slot_hash_batch(keys)
    limit = np.tile(np.asarray(CHAIN_LEVEL_LIMITS[:3] + (leaf_limit,), np.int64), n)
    ones = np.ones(n * CHAIN_ROWS, np.int64)
    return (kh, ones, limit, ones * CHAIN_DURATION, np.zeros(n * CHAIN_ROWS, np.int32),
            np.repeat(np.arange(n, dtype=np.int64), CHAIN_ROWS), np.full_like(kh, kh[0]))


def zipf_chain_rows(rng, n: int):
    ts = keystreams.tenant_zipf_ids(CHAIN_TENANTS, n, rng).tolist()
    return chain_rows(ts, [f"k:{t}:{int(x)}" for t, x in zip(ts, rng.integers(1 << 14, size=n))])


def refusing_levels(status: np.ndarray) -> np.ndarray:
    """Per chain (rows in caller order, CHAIN_ROWS a chain), the index of
    the shallowest refusing level, or CHAIN_ROWS where all admitted."""
    over = status.reshape(-1, CHAIN_ROWS) == 1
    return np.where(over.any(axis=1), over.argmax(axis=1), CHAIN_ROWS)


def level_shares(levels: np.ndarray) -> dict:
    counts = np.bincount(levels, minlength=CHAIN_ROWS + 1)
    return {name: int(c) / levels.shape[0] for name, c in
            zip(CHAIN_LEVELS + ("admitted",), counts)}


def chain_path(card: str, ladder, writeback) -> dict:
    """Quota chains on the card at the zipf100m two-tier deployment, with
    the mixed_tenant_zipf traffic: (a) the engine's chain decide at 8,192
    chains = 32,768 rows a decide, held against the CPU (responses,
    store and sketch bytes), then timed; (b) no partial debit: the store
    read before and after a batch in which hot tenants and spent leaves
    refuse; (c) a window of GEBC frames of 256 chains from 8 callers (a
    client process) into the GEB door of an in-process node (Instance ->
    chain lane -> TorchBackend.decide_chain)."""
    from gubernator_tpu_torch.core.engine import TorchEngine
    from gubernator_tpu_torch.core.sketches import derive_two_tier_config
    from gubernator_tpu_torch.parallel.sharded import pad_request_chained

    config, skc = derive_two_tier_config(1024)
    eng = TorchEngine(config, buckets=ladder, sketch=skc)
    eng.warmup(now=T0)
    writeback.writeback_add.launches = 0  # count this path only
    rng = np.random.default_rng(71)
    sk0 = eng.sketch.data.clone()

    # (a) checked against the CPU from the card's state, then timed
    cpu = TorchEngine(config, buckets=ladder, device="cpu", sketch=skc)
    cpu.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch, eng.sketch.data.cpu().numpy())
    now = T0
    levels = []
    for i in range(CHAIN_CHECKED):
        now += 1
        rows = zipf_chain_rows(rng, CHAINS_PER_DECIDE)
        sb, cb = eng.stats.snapshot(), cpu.stats.snapshot()
        out = eng.decide_chain_arrays(*rows, now)
        ref = cpu.decide_chain_arrays(*rows, now)
        same_as_cpu(eng, cpu, out, ref, f"chain check batch {i}",
                    stats=(delta(eng.stats.snapshot(), sb), delta(cpu.stats.snapshot(), cb)))
        levels.append(refusing_levels(out[0]))
        emit(dict(phase="check", path="chain", batch=i, rows=int(rows[0].shape[0]),
                  cpu_identical=True, refused=level_shares(levels[-1])))
    del cpu
    if not torch.equal(eng.sketch.data, sk0):
        fail("chain: a chain decide wrote the sketch")
    timed = [zipf_chain_rows(rng, CHAINS_PER_DECIDE) for _ in range(CHAIN_TIMED)]
    prep_ms = []
    for rows in timed[:5]:
        t0 = time.perf_counter()
        pad_request_chained(ladder, config.slots, 1, *rows[:5], rows[5], rows[6])
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    batch_ms, span0 = [], eng.device_span_ms
    for rows in timed:
        now += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.decide_chain_arrays(*rows, now)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if out[0].shape != (DEPTH,) or not np.isin(out[0], (0, 1)).all():
            fail("chain timed batch: responses out of range")
        levels.append(refusing_levels(out[0]))
    wall_s = sum(batch_ms) / 1e3
    main = dict(
        phase="main", path="chain", card=card, chains_per_decide=CHAINS_PER_DECIDE,
        rows_per_decide=DEPTH, timed_batches=CHAIN_TIMED,
        chains_per_s=CHAIN_TIMED * CHAINS_PER_DECIDE / wall_s, device_rows_per_s=CHAIN_TIMED * DEPTH / wall_s,
        batch_ms_median=statistics.median(batch_ms),
        batch_ms_p99=float(np.percentile(batch_ms, 99)),
        host_prep_ms_median=statistics.median(prep_ms),
        device_span_share=(eng.device_span_ms - span0) / (wall_s * 1e3),
        refused=level_shares(np.concatenate(levels)),
    )

    # (b) no partial debit, in a fresh 60 s window (leg (a) spent every
    # tenant): the leaves of CHAIN_LEAF_REFUSALS chains under cold tenants
    # (56-63: each ~0.6% of zipf(1.2) mod 64) are spent first (limit 1),
    # then one batch of those chains and zipf chains, whose hot tenants
    # refuse; every key's remaining must fall by exactly the hits of the
    # ADMITTED chains that name it
    spent = chain_rows([56 + i % 8 for i in range(CHAIN_LEAF_REFUSALS)],
                       [f"x:{i}" for i in range(CHAIN_LEAF_REFUSALS)], leaf_limit=1)
    now += CHAIN_DURATION + 1
    if (eng.decide_chain_arrays(*spent, now)[0] != 0).any():
        fail("chain no-partial-debit: a spending chain under a cold tenant was refused")
    zipf = zipf_chain_rows(rng, CHAINS_PER_DECIDE - CHAIN_LEAF_REFUSALS)
    rows = tuple(np.concatenate([a, b]) for a, b in zip(zipf[:6], spent[:6])) + (
        np.full(DEPTH, zipf[6][0]),)
    rows[5][zipf[0].shape[0]:] += CHAINS_PER_DECIDE  # chain ids stay distinct
    now += 1
    keys, first, inv = np.unique(rows[0], return_index=True, return_inverse=True)
    before = eng.snapshot_read(keys, now)
    sb = eng.stats.snapshot()
    out = eng.decide_chain_arrays(*rows, now)
    after = eng.snapshot_read(keys, now)
    lv = refusing_levels(out[0])
    admitted_rows = np.repeat(lv == CHAIN_ROWS, CHAIN_ROWS)
    debit = np.bincount(inv.reshape(-1), weights=admitted_rows * rows[1], minlength=keys.shape[0])
    want = np.array([(b[2] if b is not None else rows[2][f]) for b, f in zip(before, first)])
    got = np.array([a[2] if a is not None else -1 for a in after])
    bad = np.flatnonzero(got != want - debit)
    by_level = level_shares(lv)
    if bad.shape[0] or delta(eng.stats.snapshot(), sb)["dropped"]:
        fail(f"chain no-partial-debit: {bad.shape[0]} keys moved by other than their "
             f"admitted chains' hits (first: {bad[:5].tolist()})")
    n_tenant = int((lv == 2).sum())
    n_leaf = int((lv == 3).sum())
    if n_tenant == 0 or n_leaf == 0:
        fail(f"chain no-partial-debit: refusals at the tenant {n_tenant}, leaf {n_leaf}")
    emit(dict(phase="check", path="chain", leg="no_partial_debit", keys=int(keys.shape[0]),
              chains=CHAINS_PER_DECIDE, refused_tenant=n_tenant, refused_leaf=n_leaf,
              refused=by_level, exact_debits=True))
    decides = eng.stats.snapshot()["batches"]
    launches = writeback.writeback_add.launches
    chunks = eng.install_chunks + eng.gossip_chunks
    if launches != decides + chunks or launches == 0:
        fail(f"chain engine legs: writeback kernel launched {launches} times for {decides} "
             f"decides + {chunks} chunks")
    del eng, sk0
    torch.cuda.empty_cache()

    # (c) serving: GEBC frames into the GEB door of an in-process node
    serving = chain_window(card, writeback)
    main.update(engine_launches=launches, engine_decides=decides, serving={
        k: serving[k] for k in ("chains_per_s", "device_rows_per_s", "chains_per_flush",
                                "host_expansion_ms_per_flush", "device_span_share",
                                "kernel_launches", "decides", "chunks")})
    emit(main)
    return dict(launches=launches + serving["kernel_launches"],
                decides=decides + serving["decides"])


def chain_window(card: str, writeback) -> dict:
    """A window of the scenario's GEBC frames (256 chains, 8 callers, in a
    client process: this script with --geb-window chain) into the GEB door
    of a node of the zipf100m deployment built as the daemon builds it,
    run here so that the chain call can be timed around: the host ms a
    flush outside the engine's chained decide is the expansion and
    collapse of TorchBackend.decide_chain."""
    from gubernator_tpu_torch.cluster import LocalCluster
    from gubernator_tpu_torch.serve.stages import STAGES

    g, geb = free_ports(2)
    env = dict(SERVING_ENV, GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}")
    c = LocalCluster([f"127.0.0.1:{g}"], env=env, geb_ports=[geb])
    c.start(timeout=BOOT_S)
    try:
        s = c.servers[0]
        backend, eng = s.backend, s.backend.engine
        calls = dict(decide_chain=[], decide_chain_arrays=[])

        def timed(name, fn):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    calls[name].append((time.perf_counter() - t0) * 1e3)
            return wrapper

        backend.decide_chain = timed("decide_chain", backend.decide_chain)
        eng.decide_chain_arrays = timed("decide_chain_arrays", eng.decide_chain_arrays)
        writeback.writeback_add.launches = 0  # count this leg only
        b0, span0 = backend.stats()["batches"], eng.device_span_ms
        chunks0 = eng.install_chunks + eng.gossip_chunks
        STAGES.reset()
        w = client_process(["--geb-window", "chain", f"127.0.0.1:{geb}", str(WINDOW_S), "81"],
                           WINDOW_S, "the chain window")
        launches = writeback.writeback_add.launches
        decides = backend.stats()["batches"] - b0
        chunks = eng.install_chunks + eng.gossip_chunks - chunks0
        span_ms = eng.device_span_ms - span0
        stages = STAGES.snapshot()["stages"]
    finally:
        c.stop()
    torch.cuda.empty_cache()
    if decides <= 0 or launches != decides + chunks:
        fail(f"chain window: writeback kernel launched {launches} times for {decides} decides "
             f"+ {chunks} chunks")
    flush, engine = calls["decide_chain"], calls["decide_chain_arrays"]
    refused = w.pop("refused_by_level")
    w.update(
        chains_per_s=w["decisions_per_s"], device_rows_per_s=w["decisions_per_s"] * CHAIN_ROWS,
        flushes=len(flush), chains_per_flush=w["items"] / max(len(flush), 1),
        flush_ms_median=statistics.median(flush), engine_ms_median=statistics.median(engine),
        host_expansion_ms_per_flush=float(np.mean(flush) - np.mean(engine)),
        device_span_ms=span_ms, device_span_share=span_ms / (w["seconds"] * 1e3),
        refused={k: v / w["items"] for k, v in refused.items()},
        kernel_launches=launches, decides=decides, chunks=chunks,
        submit_host_ms=stages.get("submit_host", {}).get("mean_ms"),
        batch_queue_ms=stages.get("batch_queue", {}).get("mean_ms"))
    w.pop("decisions_per_s")
    emit(dict(phase="window", path="chain", card=card, **w))
    return w


# -- durability: the exact backend's sibling managers on the card ------------

DUR_WINDOWS = 1 << 20  # live windows of the engine leg (the full store: 16.8M entries)
DUR_LIMIT = 8  # each window's limit; the OVER pass spends the other 7
DUR_ID_BASE = 1 << 40  # key ids no other phase uses
DUR_CANARIES = 64  # OVER canaries of the full-fleet restart
DUR_RING_CANARIES = 96  # OVER canaries of the replication/rescale leg
CKPT_INTERVAL_MS = 250


def _warmup_launches(engine) -> int:
    """writeback launches of one engine warmup: one decide and one
    one-chunk window install per ladder rung (TorchEngine.warmup)."""
    return 2 * len(engine.buckets)


def _same_export(a: dict, b: dict, what: str, skip=()) -> None:
    if sorted(a) != sorted(b):
        fail(f"{what}: export columns {sorted(a)} != {sorted(b)}")
    for col in a:
        if col in skip:
            continue
        if a[col].dtype != b[col].dtype or not np.array_equal(a[col], b[col]):
            fail(f"{what}: export column {col} differs")


def _by_key(w: dict) -> dict:
    o = np.argsort(w["key_hash"], kind="stable")
    return {c: v[o] for c, v in w.items()}


async def _lane_restore(config, skc, ladder, lanes, now, ckpt_dir, device):
    """A fresh TorchBackend on `device` restored through the checkpoint
    manager's lane path (CheckpointManager._restore_lanes: install_windows
    of the full lanes on the batcher's submit thread, then the shed purge),
    as Server boot's restore() runs it after reading the files. Returns
    (engine, windows installed, install seconds)."""
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.instance import Instance

    backend = TorchBackend(config, buckets=ladder, sketch=skc, device=device)
    inst = Instance(config_from_env(dict(SERVING_ENV, GUBER_CHECKPOINT_DIR=ckpt_dir)), backend)
    try:
        t = time.monotonic()
        n = await inst.checkpoint._restore_lanes(lanes, now)
        torch.cuda.synchronize()
        return backend.engine, n, time.monotonic() - t
    finally:
        await inst.stop()


def durability_engine_leg(card: str, ladder, writeback) -> dict:
    """(a) The zipf100m two-tier engine filled with DUR_WINDOWS live windows
    (a quarter each token, leaky, sliding, GCRA; an eighth then spent to
    OVER): export_windows on the device against a CPU engine given the same
    store, write_checkpoint, read_checkpoint, a restore into a fresh engine
    through the checkpoint manager's lane path, a flat repartition, and a
    checked batch identical on the original, the restored and a CPU engine
    restored from the same files."""
    import shutil
    import tempfile

    from gubernator_tpu_torch.core.engine import TorchEngine
    from gubernator_tpu_torch.core.sketches import derive_two_tier_config
    from gubernator_tpu_torch.core.store import FLAG_ALGO_SLIDING
    from gubernator_tpu_torch.serve.checkpoint import (
        LANE_COLS,
        read_checkpoint,
        write_checkpoint,
    )

    config, skc = derive_two_tier_config(1024)
    windows, depth = DUR_WINDOWS, DEPTH
    eng = TorchEngine(config, buckets=ladder, sketch=skc)
    eng.warmup(now=T0)
    writeback.writeback_add.launches = 0  # this leg from here on
    decides = 0
    kh = keystreams.hash_ids(np.arange(windows, dtype=np.int64) + DUR_ID_BASE)
    algo = (np.arange(windows) % 4).astype(np.int32)
    one = np.ones(depth, np.int64)
    no_gnp = np.zeros(depth, bool)
    now = T0
    t0 = time.monotonic()
    for c in range(windows // depth):
        sl = slice(c * depth, (c + 1) * depth)
        now += 1
        eng.decide_arrays(kh[sl], one, one * DUR_LIMIT, one * DURATION_100M, algo[sl],
                          no_gnp, now)
        decides += 1
    # an eighth spends its budget (OVER from then on), and a peek pass over
    # it persists the token windows' OVER status: the sticky bit
    for hits in (DUR_LIMIT - 1, 0):
        for c in range(windows // depth // 8):
            sl = slice(c * depth, (c + 1) * depth)
            now += 1
            eng.decide_arrays(kh[sl], one * hits, one * DUR_LIMIT, one * DURATION_100M,
                              algo[sl], no_gnp, now)
            decides += 1
    torch.cuda.synchronize()
    fill_s = time.monotonic() - t0

    # export on the device against a CPU engine given the same store
    now += 1
    w = eng.export_windows(now)
    export = dict(eng.last_export)
    if w["key_hash"].shape[0] != windows:
        fail(f"durability: export holds {w['key_hash'].shape[0]} windows, not {windows}")
    cpu = TorchEngine(config, buckets=ladder, device="cpu")
    cpu.load_state(eng.store.data.cpu().numpy(), eng.clock.epoch)
    _same_export(w, cpu.export_windows(now), "durability: device export vs CPU export")
    del cpu
    sticky = int(w["is_over"].sum())
    algos = sorted(set(np.unique(w["flags"] & 14).tolist()))
    if sticky != windows // 32 or algos != [0, 2, 4, 8]:
        fail(f"durability: export has {sticky} sticky windows and algorithm bits {algos}")

    d = tempfile.mkdtemp(prefix="guber-ckpt-")
    try:
        t0 = time.monotonic()
        write_checkpoint(d, [], {c: w[c] for c in LANE_COLS}, "chip-smoke", now)
        write_s = time.monotonic() - t0
        disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.monotonic()
        manifest, snaps, lanes = read_checkpoint(d)
        read_s = time.monotonic() - t0
        if manifest["lane_windows"] != windows or snaps:
            fail(f"durability: read back {manifest['lane_windows']} lane windows")

        restored, n_inst, install_s = asyncio.run(
            _lane_restore(config, skc, ladder, lanes, now, d, "cuda"))
        if n_inst != windows or restored.install_chunks != windows // max(ladder):
            fail(f"durability: restore installed {n_inst} windows in "
                 f"{restored.install_chunks} chunks")
        t0 = time.monotonic()
        moved = eng.repartition(now=now)
        torch.cuda.synchronize()
        repartition_s = time.monotonic() - t0
        ref = _by_key(w)
        _same_export(_by_key(restored.export_windows(now)), ref,
                     "durability: restored export vs the original's")
        _same_export(_by_key(moved.export_windows(now)), ref,
                     "durability: repartitioned export vs the original's")

        # the checked batch over restored keys, three ways
        cpu_r, _n, _s = asyncio.run(_lane_restore(config, skc, ladder, lanes, now, d, "cpu"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(31)
    sel = np.sort(rng.choice(windows, depth, replace=False))
    fields = (kh[sel], rng.choice([0, 1, 1, 2], depth).astype(np.int64), one * DUR_LIMIT,
              one * DURATION_100M, algo[sel], no_gnp)
    now += 5
    outs = [e.decide_arrays(*fields, now) for e in (eng, restored, cpu_r)]
    decides += 2
    for name, out in (("restored", outs[1]), ("CPU-restored", outs[2])):
        for a, b in zip(outs[0], out):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"durability: the checked batch answers differently on the {name} engine")
    over = int((np.asarray(outs[0][0]) == 1).sum())
    if not 0 < over < depth:
        fail(f"durability: the checked batch has {over} OVER answers of {depth}")
    e_orig, e_rest, e_cpu = (_by_key(e.export_windows(now)) for e in (eng, restored, cpu_r))
    _same_export(e_rest, e_cpu, "durability: restored export vs CPU-restored after the batch")
    # the ts lane is carried raw in engine-ms (the reference's layout), and
    # the restored engine's clock has its own epoch: where ts is a time
    # (token, leaky, GCRA) it differs by the epoch shift once a batch writes
    # it, so it is held to the original's on the sliding entries (a count)
    _same_export(e_rest, e_orig, "durability: restored export vs the original's after the batch",
                 skip=("ts",))
    sld = (e_orig["flags"] & FLAG_ALGO_SLIDING) != 0
    if not np.array_equal(e_orig["ts"][sld], e_rest["ts"][sld]):
        fail("durability: a sliding entry's count differs after the batch")
    eng.export_windows(now)  # once more, warm: no allocation left to make
    warm = {k: eng.last_export[k] for k in ("ms", "mask_ms", "copy_ms")}
    launches = writeback.writeback_add.launches
    chunks = restored.install_chunks + moved.install_chunks
    if launches != decides + chunks:
        fail(f"durability: writeback launched {launches} times for {decides} decides "
             f"+ {chunks} install chunks")
    recover_s = read_s + install_s
    out = dict(
        phase="durability", leg="engine", card=card, windows=windows,
        store_shape=list(eng.store.data.shape),
        sketch_shape=list(eng.sketch.data.shape),
        sticky_windows=sticky, fill_s=fill_s,
        export_ms=export["ms"], export_mask_ms=export["mask_ms"],
        export_copy_ms=export["copy_ms"], export_warm=warm, export_bytes=export["bytes"],
        export_rows_per_s=windows / (export["ms"] / 1e3),
        write_s=write_s, disk_mib=disk / (1 << 20), disk_bytes_per_window=disk / windows,
        write_rows_per_s=windows / write_s,
        read_s=read_s, read_rows_per_s=windows / read_s,
        install_s=install_s, install_chunks=restored.install_chunks,
        install_rows_per_s=windows / install_s,
        recover_s=recover_s, recover_rows_per_s=windows / recover_s,
        repartition_s=repartition_s, repartition_rows_per_s=windows / repartition_s,
        epoch_shift_ms=int(restored.clock.epoch - eng.clock.epoch),
        checked=dict(rows=depth, over=over, identical=3),
        decides=decides, chunks=chunks, launches=launches,
        reduced=[f"live windows {windows} of the store's "
                 f"{config.slots * config.rows} entries (the JSON checkpoint of the "
                 f"full store would be ~{disk / windows * config.slots * config.rows / 2**30:.1f}"
                 " GiB at this run's bytes a window, encoded on the host)"],
    )
    del eng, restored, moved, cpu_r
    torch.cuda.empty_cache()
    return out


async def _canary_answers(client, reqs, what: str) -> list:
    resps = await client.get_rate_limits(reqs, timeout=120)
    bad = [r.error for r in resps if r.error]
    if bad:
        fail(f"durability {what}: error answers {bad[:3]}")
    return resps


async def _restart_leg(card: str) -> dict:
    import shutil
    import tempfile

    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch.client import AsyncV1Client
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    d = tempfile.mkdtemp(prefix="guber-ckpt-")
    g, h = free_ports(2)
    env = dict(SERVING_ENV, GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}",
               GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}", GUBER_CHECKPOINT_DIR=d,
               GUBER_CHECKPOINT_INTERVAL_MS=str(CKPT_INTERVAL_MS))
    canaries = [types.RateLimitReq(
        name="canary", unique_key=f"c{i}", hits=5, limit=5, duration=DURATION_100M,
        algorithm=types.Algorithm(i % 4)) for i in range(DUR_CANARIES)]
    after = [types.RateLimitReq(name=r.name, unique_key=r.unique_key, hits=1, limit=r.limit,
                                duration=r.duration, algorithm=r.algorithm) for r in canaries]
    counted = {"decides": 0, "chunks": 0, "warmups": 0}

    def count(server):
        e = server.backend.engine
        counted["decides"] += e.stats.snapshot()["batches"]
        counted["chunks"] += e.install_chunks + e.gossip_chunks
        counted["warmups"] += _warmup_launches(e)

    try:
        first = Server(config_from_env(env))
        t0 = time.monotonic()
        await first.start()
        boot_s = time.monotonic() - t0
        client = AsyncV1Client(f"127.0.0.1:{g}")
        try:
            await _canary_answers(client, canaries, "restart: spend")
            over = await _canary_answers(client, after, "restart: drive over")
        finally:
            await client.close()
        if any(int(r.status) != 1 for r in over):
            fail("durability restart: a canary is not OVER before the stop")
        # one flush pass lands on disk (the loop's interval)
        t_drive = types.millisecond_now()
        deadline = time.monotonic() + 30
        while first.instance.checkpoint.last_ok_ms < t_drive:
            if time.monotonic() > deadline:
                fail("durability restart: no checkpoint flush landed within 30 s")
            await asyncio.sleep(0.05)
        stall = dict(first.backend.engine.last_export)
        t_stop = time.monotonic()
        drain = await first.drain()
        await first.stop()
        count(first)
        if "checkpoint_flush" not in drain:
            fail(f"durability restart: the drain wrote no final checkpoint: {drain}")
        del first
        second = Server(config_from_env(env))
        t0 = time.monotonic()
        await second.start()  # restore() runs inside, before any door opens
        boot2_s = time.monotonic() - t0
        client = AsyncV1Client(f"127.0.0.1:{g}")
        try:
            got = await _canary_answers(client, after, "restart: after the restore")
        finally:
            await client.close()
        stop_to_serving_s = time.monotonic() - t_stop
        under = sum(int(r.status) != 1 for r in got)
        # the scrape runs off this loop: the server answers on it
        text = await asyncio.to_thread(http_text, f"http://127.0.0.1:{h}/metrics")
        restored = metric_value(text, "restored_windows_total")
        lag = metric_value(text, "restore_lag_seconds")
        if under or restored < DUR_CANARIES:
            fail(f"durability restart: {under} canaries under the limit after the restore, "
                 f"restored_windows_total {restored}")
        await second.drain()
        await second.stop()
        count(second)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dict(
        phase="durability", leg="restart", card=card, canaries=DUR_CANARIES,
        canary_under_admissions=under, boot_s=boot_s, drain_s=drain["total"],
        drain_steps={k: v for k, v in drain.items() if k != "total"},
        restart_boot_s=boot2_s, stop_to_serving_s=stop_to_serving_s,
        restored_windows_total=restored, restore_lag_seconds=lag,
        checkpoint_interval_ms=CKPT_INTERVAL_MS,
        export_stall_ms=stall["ms"], export_stall_mask_ms=stall["mask_ms"],
        export_stall_bytes=stall["bytes"],
        export_stall_windows=stall["windows"], **counted,
    )


def _ring(types, addrs, me):
    return [types.PeerInfo(address=a, is_owner=(a == me)) for a in addrs]


def _ring_leg(card: str, writeback) -> dict:
    """(c) Replication and rescale on three nodes of one LocalCluster: token
    canaries driven OVER at their owners' doors and one replication sync;
    one owner taken out of the other two's ring, each of its canaries asked
    at its successor (now its owner), which answers from the standby
    snapshot (metadata replicated=true); then a fourth node joins the ring
    of the two, the rescale hands the windows it now owns over, and each
    such canary is asked at the new node's door. Every canary answer after
    the drive must be OVER."""
    import gubernator_tpu_torch.api.types as types
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.cluster import LocalCluster
    from gubernator_tpu_torch.core.hashing import ring_hash
    from gubernator_tpu_torch.serve import metrics
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    addrs = balanced_addresses(ring_hash, CLUSTER_NODES)
    env = dict(SERVING_ENV, GUBER_PEER_TIMEOUT_MS="10000", GUBER_GLOBAL_TIMEOUT_MS="10000",
               GUBER_GLOBAL_SYNC_WAIT_MS="600000", GUBER_REPLICATION="1", GUBER_RESCALE="1",
               GUBER_REPLICATION_SYNC_WAIT_MS="50")
    cl = LocalCluster(addrs, env=env)
    cl.start(timeout=BOOT_S)
    fourth = None
    counted = {"decides": 0, "chunks": 0, "warmups": 0}
    try:
        for s in cl.servers:
            cl.run(s.instance.promoter.stop())
        base = [(s.backend.stats()["batches"], s.backend.engine.install_chunks
                 + s.backend.engine.gossip_chunks) for s in cl.servers]
        launches0 = writeback.writeback_add.launches
        canaries = [types.RateLimitReq(name="ring", unique_key=f"r{i}", hits=5, limit=5,
                                       duration=DURATION_100M)
                    for i in range(DUR_RING_CANARIES)]
        after = [types.RateLimitReq(name="ring", unique_key=r.unique_key, hits=1, limit=5,
                                    duration=DURATION_100M) for r in canaries]
        owner = [_owner(ring_hash, addrs, r.hash_key()) for r in canaries]
        answers = []  # every canary answer after the drive: all must be OVER

        def ask(addr: str, reqs: list, what: str, record: bool = True) -> list:
            with V1Client(addr) as c:
                resps = c.get_rate_limits(reqs, timeout=120)
            bad = [r.error for r in resps if r.error]
            if bad:
                fail(f"durability ring {what}: error answers {bad[:3]}")
            if record:
                answers.extend(resps)
            return resps

        for node in range(CLUSTER_NODES):  # driven OVER at their owners
            mine = [j for j in range(len(canaries)) if owner[j] == node]
            ask(addrs[node], [canaries[j] for j in mine], "spend", record=False)
            ask(addrs[node], [after[j] for j in mine], "drive over")
        # one replication sync: the owners' loops (50 ms) ship the dirty
        # windows to their successors; a loop's send may still be in flight
        # when an explicit flush finds nothing dirty, so wait for the rows
        t0 = time.monotonic()
        for s in cl.servers:
            cl.run(s.instance.repl.flush_once(), timeout=120)
        while sum(s.instance.repl.standby_len for s in cl.servers) < len(canaries):
            if time.monotonic() - t0 > 30:
                break
            time.sleep(0.01)
        sync_s = time.monotonic() - t0
        standby = sum(s.instance.repl.standby_len for s in cl.servers)
        if standby != len(canaries):
            fail(f"durability ring: {standby} standby rows for {len(canaries)} canaries")

        # take out the node other than 0 that owns the most canaries
        x = max((1, 2), key=owner.count)
        rest = [a for i, a in enumerate(addrs) if i != x]
        for i, s in enumerate(cl.servers):
            if i != x:
                cl.run(s.instance.set_peers(_ring(types, rest, addrs[i])))
        taken = [j for j in range(len(after)) if owner[j] == x]
        replicated = 0
        for succ in rest:
            mine = [after[j] for j in taken if rest[_owner(ring_hash, rest,
                                                            after[j].hash_key())] == succ]
            if mine:
                got = ask(succ, mine, "takeover")
                replicated += sum(r.metadata.get("replicated") == "true" for r in got)
        if not taken or replicated != len(taken):
            fail(f"durability ring: {replicated} of {len(taken)} taken-over canaries "
                 "answered from a standby snapshot")

        # a fourth node joins the ring of the two that remain; its port is
        # drawn so that its ring arc takes some canaries from them
        for _ in range(200):
            four = rest + [f"127.0.0.1:{free_ports(1)[0]}"]
            moved = [j for j, r in enumerate(canaries)
                     if _owner(ring_hash, four, r.hash_key()) == 2]
            if len(moved) >= 8:
                break
        else:
            fail("durability ring: no fourth port takes 8 canaries")
        moved0 = metrics.RESCALE_KEYS_MOVED._value.get()
        conf = config_from_env(dict(cl._env))
        conf.grpc_address = conf.advertise_address = four[-1]
        conf.peers = list(four)
        fourth = Server(conf)
        t0 = time.monotonic()
        cl.run(fourth.start(), timeout=BOOT_S)
        boot_s = time.monotonic() - t0
        cl.run(fourth.instance.promoter.stop())
        t_flip = time.monotonic()
        for i, s in enumerate(cl.servers):
            if i != x:
                cl.run(s.instance.set_peers(_ring(types, four, addrs[i])))
        # the rescale loops hand the moved windows over on their own
        deadline = time.monotonic() + 30
        while metrics.RESCALE_KEYS_MOVED._value.get() - moved0 < len(moved):
            if time.monotonic() > deadline:
                fail("durability ring: the rescale handoff did not land within 30 s")
            time.sleep(0.01)
        handoff_s = time.monotonic() - t_flip
        moved_keys = metrics.RESCALE_KEYS_MOVED._value.get() - moved0
        got = ask(four[-1], [after[j] for j in moved], "after the node add")
        if any(int(r.status) != 1 for r in got):
            fail("durability ring: a moved canary is under the limit at its new owner")
        under = sum(int(r.status) != 1 for r in answers)
        if under:
            fail(f"durability ring: {under} canary answers under the limit")
        for (b0, c0), s in zip(base, cl.servers):
            counted["decides"] += s.backend.stats()["batches"] - b0
            counted["chunks"] += (s.backend.engine.install_chunks
                                  + s.backend.engine.gossip_chunks - c0)
    finally:
        if fourth is not None:
            cl.run(fourth.stop(), timeout=60)
        cl.stop()
    launches = writeback.writeback_add.launches - launches0
    e4 = fourth.backend.engine
    counted["decides"] += e4.stats.snapshot()["batches"]
    counted["chunks"] += e4.install_chunks + e4.gossip_chunks
    counted["warmups"] += _warmup_launches(e4)
    return dict(
        phase="durability", leg="ring", card=card, nodes=CLUSTER_NODES + 1,
        canaries=DUR_RING_CANARIES, standby_rows=standby, replication_sync_s=sync_s,
        removed_node=x,
        taken_over=len(taken), replicated_answers=replicated,
        moved_to_new_node=len(moved), rescale_keys_moved=moved_keys,
        fourth_boot_s=boot_s, handoff_s=handoff_s,
        canary_answers=len(answers), canary_under_admissions=under,
        launches=launches, **counted,
    )


def durability_path(card: str, ladder, writeback) -> dict:
    """The durability phase: (a) the engine leg, (b) a full-fleet restart
    from a checkpoint, (c) replication and rescale on card nodes. Every
    writeback launch of the phase is one decide, one install or gossip
    chunk, or one of a booting node's warmup launches."""
    engine = durability_engine_leg(card, ladder, writeback)
    emit(engine)
    writeback.writeback_add.launches = 0
    restart = asyncio.run(_restart_leg(card))
    emit(restart)
    b_launches = writeback.writeback_add.launches
    want = restart["decides"] + restart["chunks"] + restart["warmups"]
    if b_launches != want:
        fail(f"durability restart: writeback launched {b_launches} times for {want}")
    ring = _ring_leg(card, writeback)
    emit(ring)
    want = ring["decides"] + ring["chunks"] + ring["warmups"]
    if ring["launches"] != want:
        fail(f"durability ring: writeback launched {ring['launches']} times for {want}")
    return dict(launches=engine["launches"] + b_launches + ring["launches"])


# -- the workloads phase: the port's bench_serving and loadgen ---------------

#: leg (a): the port's cli/bench_serving scenarios in this process, on the
#: card, each at its deployment's own flags (1-2 s windows)
WORKLOAD_SCENARIOS = (
    ("zipf10m", ["--scenario", "zipf10m", "--depths", str(DEPTH), "--keys", "10000000",
                 "--store-mib", "1024", "--group", "4096", "--seconds", "2"]),
    ("zipf100m", ["--scenario", "zipf100m", "--rounds", "2", "--seconds", "1"]),
    ("key-churn", ["--scenario", "key-churn", "--seconds", "1"]),
    ("shed", ["--scenario", "shed", "--seconds", "1"]),
    ("flash-crowd", ["--scenario", "flash-crowd", "--algorithm", "sliding", "--seconds", "1"]),
    ("mixed-tenant-zipf", ["--scenario", "mixed-tenant-zipf", "--chain-depth", "3",
                           "--seconds", "1"]),
    ("gcra-vs-token", ["--scenario", "gcra-vs-token", "--seconds", "1"]),
    ("cluster", ["--backend", "tpu", "--nodes", "3", "--seconds", "1"]),
    # the compiled edge in front of node 0, its batched gRPC row alone:
    # fed single-item requests by 16 callers, the edge stops sending
    # frames on a gVisor (runsc) host after a few hundred requests, in
    # front of a CPU node as of a card node (PERF.md §6)
    ("cluster-edge", ["--backend", "tpu", "--nodes", "3", "--edge", "--edge-only",
                      "--seconds", "1"]),
)
DAEMONS = 3
LOADGEN_S = 5.0  # each leg of (b)
#: leg (b): the port's loadgen, in a process of its own, against the
#: three daemons; (name, where it aims, its flags, the over-limit share)
LOADGEN_LEGS = (
    ("forward", "grpc", ["--protocol", "grpc", "--batch", "1000", "--concurrency", "16",
                         "--share", "0.9"], 0.9),
    ("ring_route", "geb", ["--protocol", "geb", "--mode", "fast", "--ring-route", "1",
                           "--batch", "1000", "--concurrency", "16", "--share", "0.9",
                           "--keyspace", "262144"], 0.9),
    ("chains", "geb", ["--protocol", "geb", "--chain-depth", "3", "--batch", "256",
                       "--concurrency", "8", "--share", "0.5"], 0.5),
)


class EngineCensus:
    """Every TorchEngine built and every warmup run while it is open: the
    writeback launches those engines owe, their decides plus install and
    gossip chunks, plus two a ladder rung for each warmup (one decide and
    one install; the warmup then zeroes the engine's counts)."""

    def __enter__(self):
        from gubernator_tpu_torch.parallel.sharded import TorchEngine

        self.cls, self.engines, self.warmups = TorchEngine, [], 0
        self.saved = (TorchEngine.__init__, TorchEngine.warmup)
        init, warmup = self.saved

        def counted_init(eng, *a, **kw):
            init(eng, *a, **kw)
            self.engines.append(eng)

        def counted_warmup(eng, *a, **kw):
            warmup(eng, *a, **kw)
            self.warmups += _warmup_launches(eng)

        self.cls.__init__, self.cls.warmup = counted_init, counted_warmup
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.warmup = self.saved

    def owed(self) -> dict:
        return dict(engines=len(self.engines),
                    decides=sum(e.stats.batches for e in self.engines),
                    chunks=sum(e.install_chunks + e.gossip_chunks for e in self.engines),
                    warmups=self.warmups)


def _scenario_summary(name: str, doc: dict) -> dict:
    """The headline numbers of one scenario's JSON (every row stays in the
    `doc` field beside them)."""
    rows = doc.get("rows") or doc.get("results") or []
    if name.startswith("cluster"):
        return {r["name"]: r.get("decisions_per_sec", r["ops_per_sec"]) for r in rows}
    if name == "gcra-vs-token":
        return {r["algorithm"]: dict(admitted_per_sec=r["admitted_per_sec"],
                                     admission_gap_cv=r["admission_gap_cv"],
                                     max_refusal_run=r["max_refusal_run"]) for r in rows}
    keys = ("decisions_per_sec", "chains_per_sec", "mean_device_batch", "over_limit_share",
            "refusal_share", "dropped_creates")
    return {r.get("metric", str(i)): {k: r[k] for k in keys if k in r}
            for i, r in enumerate(rows)}


def workloads_scenarios(card: str, writeback) -> dict:
    """Leg (a): each scenario of the port's cli/bench_serving through its
    own parser on the card, its launches held against the engines it
    built; zipf100m's tail errors held against the same calls on the CPU."""
    import contextlib
    import io

    from gubernator_tpu_torch.cli import bench_serving as bs

    # the suite's fixed ports, drawn free here
    ports = free_ports(DAEMONS + 3)
    bs.ADDRESSES = [f"127.0.0.1:{p}" for p in ports[:DAEMONS]]
    bs.PYTHON_HTTP_ADDR = f"127.0.0.1:{ports[DAEMONS]}"
    bs.EDGE_PORT, bs.EDGE_GRPC_PORT = ports[DAEMONS + 1:]
    out = {}
    for name, argv in WORKLOAD_SCENARIOS:
        stdout = io.StringIO()
        writeback.writeback_add.launches = 0
        t0 = time.monotonic()
        with EngineCensus() as census, contextlib.redirect_stdout(stdout):
            rc = bs.main(argv + ["--json"])
        seconds = time.monotonic() - t0
        launches = writeback.writeback_add.launches
        owed = census.owed()
        del census
        torch.cuda.empty_cache()
        lines = stdout.getvalue().strip().splitlines()
        if rc != 0 or not lines:
            fail(f"workloads {name}: exit {rc}, {len(lines)} lines of JSON")
        doc = json.loads(lines[-1])
        rows = doc.get("rows") or doc.get("results")
        if not rows or any(r.get("errors") for r in rows):
            fail(f"workloads {name}: rows {rows}")
        want = owed["decides"] + owed["chunks"] + owed["warmups"]
        if launches != want or launches == 0:
            fail(f"workloads {name}: writeback launched {launches} times for {owed}")
        rec = dict(phase="workloads", leg="scenarios", scenario=name, card=card, argv=argv,
                   seconds=seconds, launches=launches, **owed,
                   summary=_scenario_summary(name, doc))
        if name == "zipf10m":
            rec["rung"], rec["mean_device_batch"] = DEPTH, rows[0]["mean_device_batch"]
        if name == "zipf100m":
            # the card's tail errors against the same calls on the CPU: the
            # sketch is integer state, so the dicts are equal
            t0 = time.monotonic()
            cpu_ab = bs.measure_tail_error_ab(device="cpu")
            cpu_arms = {arm: bs.measure_tail_error(algorithm=arm, device="cpu")
                        for arm in ("sliding", "gcra")}
            if doc["tail_error_derivation_ab"] != cpu_ab or doc["tail_error_arms"] != cpu_arms:
                fail("workloads zipf100m: the card's tail errors differ from the CPU's")
            if doc["tail_error"] != cpu_ab["v2"]:
                fail("workloads zipf100m: tail_error is not the A/B's v2")
            rec.update(tail_error_cpu_identical=True, tail_error_cpu_s=time.monotonic() - t0,
                       tail_error=doc["tail_error_derivation_ab"],
                       tail_error_arms=doc["tail_error_arms"],
                       paired_ratios=doc["paired_ratios"])
        emit(rec)
        emit(dict(phase="workloads", leg="scenarios", scenario=name, doc=doc))
        out[name] = rec
    return out


def _peer_rpcs(metrics_text: str) -> float:
    """PeersV1/GetPeerRateLimits calls a node served (forwards it owned)."""
    return sum(float(ln.split()[-1]) for ln in metrics_text.splitlines()
               if ln.startswith("grpc_request_counts_total{") and "GetPeerRateLimits" in ln)


def _wait_listening(proc, log, what: str, t0: float) -> float:
    """Seconds from `t0` until the daemon logs its HTTP door open."""
    while not any("HTTP listening" in ln for ln in log):
        if proc.poll() is not None or time.monotonic() - t0 > BOOT_S:
            sys.stderr.write("".join(log[-60:]))
            fail(f"{what}: exit {proc.poll()} during boot")
        time.sleep(0.05)
    return time.monotonic() - t0


def _launch_balance(s0: list, s1: list, what: str) -> list:
    """Each daemon's writeback launches between two /v1/debug/stats reads
    against its decides and install and gossip chunks; fails on a
    difference."""
    per_node = []
    for i, (a, b) in enumerate(zip(s0, s1)):
        launches = b["kernel_launches"]["writeback_add"] - a["kernel_launches"]["writeback_add"]
        decides = b["backend"]["batches"] - a["backend"]["batches"]
        chunks = sum(b["engine_chunks"][k] - a["engine_chunks"][k]
                     for k in ("install_chunks", "gossip_chunks"))
        if launches != decides + chunks:
            fail(f"{what} daemon {i}: writeback launched {launches} times for "
                 f"{decides} decides + {chunks} install and gossip chunks")
        per_node.append(dict(launches=launches, decides=decides, chunks=chunks))
    return per_node


def workloads_daemons(card: str, single_rate: float, cluster_rate: float) -> dict:
    """Leg (b): three daemons in processes of their own, each the zipf100m
    deployment on the card, on static peers, driven by the port's loadgen
    in a process of its own, leg after leg; each daemon's launches over a
    leg held against its decides and chunks."""
    from gubernator_tpu_torch.core.hashing import ring_hash

    root = os.path.dirname(os.path.abspath(__file__))
    addrs = balanced_addresses(ring_hash, DAEMONS)
    ports = free_ports(2 * DAEMONS)
    https = [f"127.0.0.1:{p}" for p in ports[:DAEMONS]]
    gebs = ports[DAEMONS:]
    doors = ",".join(f"{a}=127.0.0.1:{p}" for a, p in zip(addrs, gebs))
    bases = [f"http://{h}" for h in https]
    procs = []
    t0 = time.monotonic()
    try:
        for i in range(DAEMONS):
            # a forward waits for its owner's batch, whose dispatch beside
            # a busy event loop takes 94-417 ms (PERF.md §5): the peer and
            # gossip deadlines rise from the reference's 500 ms, as in the
            # cluster phase, so a slow owner is not counted as a dead one
            env = dict(os.environ, **SERVING_ENV)
            env.update(GUBER_GRPC_ADDRESS=addrs[i], GUBER_ADVERTISE_ADDRESS=addrs[i],
                       GUBER_HTTP_ADDRESS=https[i], GUBER_PEERS=",".join(addrs),
                       GUBER_GEB_PORT=str(gebs[i]), GUBER_GEB_PEER_DOORS=doors,
                       GUBER_CHAINS="1", GUBER_PEER_TIMEOUT_MS="10000",
                       GUBER_GLOBAL_TIMEOUT_MS="10000",
                       PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
            procs.append(spawn_daemon(env, root)[:2])
        boot_s = max(_wait_listening(proc, log, f"workloads daemon {i}", t0)
                     for i, (proc, log) in enumerate(procs))
        tiers = [next((ln.strip() for ln in log if "store tiers:" in ln), "") for _, log in procs]
        emit(dict(phase="workloads", leg="daemons", card=card, boot_s=boot_s, addresses=addrs,
                  tiers=tiers))
        legs = {}
        for name, door, args, share in LOADGEN_LEGS:
            target = addrs[0] if door == "grpc" else f"127.0.0.1:{gebs[0]}"
            s0 = [quiet_stats(b, f"workloads {name}") for b in bases]
            m0 = [http_text(b + "/metrics") for b in bases]
            t1 = time.monotonic()
            r = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cli.loadgen",
                                target, "--json", "--duration", str(LOADGEN_S), *args],
                               cwd=root, capture_output=True, text=True,
                               timeout=LOADGEN_S + 300)
            leg_s = time.monotonic() - t1
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-4000:])
                fail(f"workloads {name}: loadgen exited {r.returncode}")
            summary = json.loads(r.stdout.strip().splitlines()[-1])
            s1 = [quiet_stats(b, f"workloads {name}") for b in bases]
            m1 = [http_text(b + "/metrics") for b in bases]
            per_node = _launch_balance(s0, s1, f"workloads {name}")
            for i, node in enumerate(per_node):
                node["peer_rpcs"] = _peer_rpcs(m1[i]) - _peer_rpcs(m0[i])
            over = summary["over_limit_share"]
            transport = summary.get("client", {}).get("transport", "grpc")
            want_transport = "grpc" if door == "grpc" else "tcp"
            if summary["errors"] or summary["sent"] <= 0:
                fail(f"workloads {name}: {summary}")
            if not share - 0.02 <= over <= share + 0.001:
                fail(f"workloads {name}: over-limit share {over}, asked {share}")
            if transport != want_transport:
                fail(f"workloads {name}: the client's transport is {transport}")
            if name == "forward" and sum(n["peer_rpcs"] for n in per_node[1:]) <= 0:
                fail("workloads forward: nodes 1-2 served no forwarded RPC")
            if name == "ring_route" and not summary["client"]["ring_routed"]:
                fail(f"workloads ring_route: the client did not route by owner: {summary}")
            legs[name] = dict(seconds=leg_s, summary=summary, per_node=per_node,
                              decisions_per_s=summary["decisions_per_sec"],
                              launches=sum(n["launches"] for n in per_node))
            emit(dict(phase="workloads", leg="daemons", loadgen=name, card=card,
                      processes=1,
                      decisions_per_s_per_process=[summary["decisions_per_sec"]],
                      **legs[name]))
        for proc, _log in procs:
            proc.terminate()
        for i, (proc, log) in enumerate(procs):
            if proc.wait(timeout=120) != 0:
                sys.stderr.write("".join(log[-40:]))
                fail(f"workloads daemon {i}: exit {proc.returncode} after SIGTERM")
    finally:
        for proc, _log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    fwd = legs["forward"]["decisions_per_s"]
    out = dict(boot_s=boot_s, legs=legs,
               launches=sum(leg["launches"] for leg in legs.values()),
               forward_decisions_per_s=fwd, one_daemon_decisions_per_s=single_rate,
               one_loop_cluster_decisions_per_s=cluster_rate,
               forward_over_one_loop_cluster=fwd / cluster_rate if cluster_rate else None,
               forward_over_one_daemon=fwd / single_rate if single_rate else None)
    emit(dict(phase="workloads", leg="daemons", card=card,
              **{k: v for k, v in out.items() if k != "legs"}))
    return out


def workloads_path(card: str, writeback, single_rate: float, cluster_rate: float) -> dict:
    """The workloads phase: (a) the bench_serving scenarios in this
    process, (b) three daemons driven by loadgen processes."""
    t0 = time.monotonic()
    scenarios = workloads_scenarios(card, writeback)
    daemons = workloads_daemons(card, single_rate, cluster_rate)
    emit(dict(phase="workloads", seconds=time.monotonic() - t0,
              scenario_seconds={k: v["seconds"] for k, v in scenarios.items()}))
    return dict(launches=sum(s["launches"] for s in scenarios.values()),
                daemon_launches=daemons["launches"])


# -- the discovery phase: membership through etcd, and the chaos soak --------

DISCOVERY_KEYS = 4096  # keys sent through each node of leg (a), owners compared
#: a SIGTERMed node leaves the others' rings (its drain deletes its etcd
#: key, their watches push), and a restarted node's registration reaches
#: every ring (from its HTTP door opening), each within this many seconds
MEMBERSHIP_BOUND_S = 10.0
#: leg (b): the soak's modes at tests/test_chaos_soak.py's lengths
SOAK_MODES = (("kill", 15.0), ("rolling", 12.0), ("restore", 12.0))
DISCOVERY_BUDGET_S = 300.0  # the phase's planned length (reported, not a gate)


def _spawn_exact_daemon(i: int, addrs: list, https: list, etcd_port: int, root: str):
    """Daemon `i` of leg (a): the soak's card deployment, the exact tier
    (BASELINE.md config 4: an int32[2^21, 128] store, 1 GiB a daemon, the
    sketch off), its peers found through the fake etcd (no GUBER_PEERS).
    The peer deadline rises from the reference's 500 ms as in the cluster
    phase: a forward waits on its owner's batch."""
    from gubernator_tpu_torch.cli.chaos_soak import TPU_ENV

    env = dict(os.environ, GUBER_BACKEND="tpu", **TPU_ENV)
    env.pop("GUBER_PEERS", None)
    env.update(GUBER_GRPC_ADDRESS=addrs[i], GUBER_ADVERTISE_ADDRESS=addrs[i],
               GUBER_HTTP_ADDRESS=https[i], GUBER_ETCD_ENDPOINTS=f"127.0.0.1:{etcd_port}",
               GUBER_PEER_TIMEOUT_MS="10000", GUBER_GLOBAL_TIMEOUT_MS="10000",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return spawn_daemon(env, root)[:2]


def _wait_peer_count(bases: list, want: int, bound_s: float, what: str) -> float:
    """Seconds until every node in `bases` reads peerCount `want` on
    /v1/HealthCheck; fails past `bound_s`."""
    t0 = time.monotonic()
    counts = []
    while True:
        try:
            counts = [http_json(b + "/v1/HealthCheck", timeout=5)[1]["peerCount"]
                      for b in bases]
        except OSError:
            counts = []
        if counts and all(c == want for c in counts):
            return time.monotonic() - t0
        if time.monotonic() - t0 > bound_s:
            fail(f"{what}: peer counts {counts} did not all reach {want} in {bound_s} s")
        time.sleep(0.02)


def _owners_through(bases: list, addrs: list, name: str) -> list:
    """DISCOVERY_KEYS keys sent through each node in GetRateLimits of at
    most 1,000 (hits 1 of a limit no key reaches); for each node, the
    owner each answer names (a forwarded answer's `owner` metadata, or
    the node itself for one it decided)."""
    keys = [str(k) for k in range(DISCOVERY_KEYS)]
    out = []
    for i, base in enumerate(bases):
        owners = []
        for lo in range(0, len(keys), 1000):
            body = {"requests": [dict(name=name, uniqueKey=k, hits=1, limit=1_000_000,
                                      duration=DURATION) for k in keys[lo:lo + 1000]]}
            status, resp = http_json(base + "/v1/GetRateLimits", body)
            answers = resp.get("responses", []) if status == 200 else []
            if len(answers) != len(body["requests"]):
                fail(f"discovery ring: node {i} answered {status} {str(resp)[:300]}")
            for r in answers:
                if r.get("error") or r.get("status", "UNDER_LIMIT") != "UNDER_LIMIT":
                    fail(f"discovery ring: node {i} answered {r}")
                owners.append(r.get("metadata", {}).get("owner", addrs[i]))
        out.append(owners)
    return out


def discovery_ring(card: str) -> dict:
    """Legs (a) and (c): three daemons of the exact-tier deployment find
    each other through the port's fake etcd (in this process, real gRPC);
    every node reads peerCount 3; the owners of DISCOVERY_KEYS keys sent
    through each node agree across nodes and with the ring built from the
    static peer list; node 2's SIGTERM takes it out of the others' rings
    and its restart puts it back, each within MEMBERSHIP_BOUND_S; each
    daemon's launches over each traffic pass equal its decides and
    chunks."""
    from gubernator_tpu_torch.api.types import hash_key
    from gubernator_tpu_torch.cli.fake_etcd import FakeEtcd
    from gubernator_tpu_torch.core.hashing import ring_hash

    root = os.path.dirname(os.path.abspath(__file__))
    addrs = balanced_addresses(ring_hash, DAEMONS)
    https = [f"127.0.0.1:{p}" for p in free_ports(DAEMONS)]
    bases = [f"http://{h}" for h in https]
    etcd = FakeEtcd().start()
    procs = []
    passes = []
    try:
        t0 = time.monotonic()
        procs = [_spawn_exact_daemon(i, addrs, https, etcd.port, root) for i in range(DAEMONS)]
        boot_s = max(_wait_listening(p, lg, f"discovery daemon {i}", t0)
                     for i, (p, lg) in enumerate(procs))
        join_s = _wait_peer_count(bases, DAEMONS, MEMBERSHIP_BOUND_S, "discovery join")
        registered = sorted(v.decode() for v, *_ in etcd._kv.values())
        if registered != sorted(addrs):
            fail(f"discovery: etcd holds {registered}, not {sorted(addrs)}")

        def traffic_pass(name: str) -> dict:
            want = [addrs[_owner(ring_hash, addrs, hash_key(name, str(k)))]
                    for k in range(DISCOVERY_KEYS)]
            s0 = [quiet_stats(b, f"discovery {name}") for b in bases]
            t = time.monotonic()
            owners = _owners_through(bases, addrs, name)
            seconds = time.monotonic() - t
            s1 = [quiet_stats(b, f"discovery {name}") for b in bases]
            for i, got in enumerate(owners):
                bad = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
                if bad:
                    fail(f"discovery {name}: node {i} names {got[bad[0]]} the owner of key "
                         f"{bad[0]}, the static ring {want[bad[0]]} ({len(bad)} keys differ)")
            per_node = _launch_balance(s0, s1, f"discovery {name}")
            if any(n["decides"] <= 0 for n in per_node):
                fail(f"discovery {name}: a daemon decided nothing: {per_node}")
            rec = dict(keys=DISCOVERY_KEYS, seconds=seconds,
                       forwarded_share=[sum(o != addrs[i] for o in got) / len(got)
                                        for i, got in enumerate(owners)],
                       owners_agree=True, per_node=per_node,
                       launches=sum(n["launches"] for n in per_node))
            emit(dict(phase="discovery", leg="ring", traffic=name, card=card, **rec))
            return rec

        passes.append(traffic_pass("disc"))
        # node 2 leaves: its drain deregisters before the doors close
        t = time.monotonic()
        procs[2][0].terminate()
        depart_s = _wait_peer_count(bases[:2], DAEMONS - 1, MEMBERSHIP_BOUND_S,
                                    "discovery departure")
        if procs[2][0].wait(timeout=120) != 0:
            sys.stderr.write("".join(procs[2][1][-40:]))
            fail(f"discovery: node 2 exited {procs[2][0].returncode} after SIGTERM")
        drain_s = time.monotonic() - t
        left = sorted(v.decode() for v, *_ in etcd._kv.values())
        if left != sorted(addrs[:2]):
            fail(f"discovery: after node 2's drain etcd holds {left}")
        # ... and comes back: a new process on the same addresses
        t = time.monotonic()
        procs[2] = _spawn_exact_daemon(2, addrs, https, etcd.port, root)
        reboot_s = _wait_listening(*procs[2], "discovery node 2 restart", t)
        rejoin_s = _wait_peer_count(bases, DAEMONS, MEMBERSHIP_BOUND_S, "discovery rejoin")
        passes.append(traffic_pass("disc2"))
        for proc, _log in procs:
            proc.terminate()
        for i, (proc, log) in enumerate(procs):
            if proc.wait(timeout=120) != 0:
                sys.stderr.write("".join(log[-40:]))
                fail(f"discovery daemon {i}: exit {proc.returncode} after SIGTERM")
        if etcd._kv:
            fail(f"discovery: etcd still holds {list(etcd._kv)} after every drain")
    finally:
        for proc, _log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        etcd.stop()
    out = dict(addresses=addrs, boot_s=boot_s, join_s=join_s, departure_s=depart_s,
               drain_s=drain_s, restart_boot_s=reboot_s, rejoin_s=rejoin_s,
               membership_bound_s=MEMBERSHIP_BOUND_S,
               launches=sum(p["launches"] for p in passes))
    emit(dict(phase="discovery", leg="ring", card=card, **out))
    return out


def _soak_gates(mode: str, doc: dict) -> list:
    """tests/test_chaos_soak.py's assertions on one mode's JSON, as a list
    of the ones that fail."""
    bad = []

    def need(ok: bool, what: str):
        if not ok:
            bad.append(what)

    need(doc.get("pass") is True and not doc.get("failures"), f"failures {doc.get('failures')}")
    need(doc.get("error_rate", 1.0) < 0.05, f"error rate {doc.get('error_rate')}")
    if mode == "kill":
        need(doc.get("inflight_loss") == 0, f"in-flight loss {doc.get('inflight_loss')}")
        need(doc.get("recovery_s", 1e9) <= doc.get("recovery_bound_s", 0) + 1.0,
             f"recovery {doc.get('recovery_s')} s")
        need(doc.get("faults_injected", 0) > 0, "no fault injected")
        counts = doc.get("counts", {})
        need(counts.get("degraded", 0) + counts.get("replicated", 0) > 0,
             "no degraded or replicated answer")
        need(doc.get("amnesia_outage_samples", {}).get("under", 1) == 0,
             f"outage under-admissions {doc.get('amnesia_outage_samples')}")
        need(doc.get("amnesia_outage_samples", {}).get("over", 0) > 0,
             "no OVER answer in the outage")
        need(doc.get("reconcile_lag_s") is not None, "no reconcile")
        need(doc.get("amnesia_reconciled_samples", {}).get("under", 1) == 0,
             f"reconciled under-admissions {doc.get('amnesia_reconciled_samples')}")
    else:
        samples = doc.get("canary_samples", {})
        need(samples.get("under", 1) == 0, f"canary under-admissions {samples}")
        need(samples.get("over", 0) > 30, f"canary over-limit samples {samples}")
    if mode == "rolling":
        restarts = doc.get("restarts", [])
        need(len(restarts) == 3 and all(r["drain_exit"] == 0 for r in restarts),
             f"restarts {restarts}")
        need(doc.get("keys_moved_total", 0) > 0, "no key moved")
        need(doc.get("handoff_lag_max_s") is not None
             and doc["handoff_lag_max_s"] <= doc.get("handoff_lag_bound_s", 0),
             f"handoff lag {doc.get('handoff_lag_max_s')} s")
    if mode == "restore":
        cycles = doc.get("cycles", [])
        need(len(cycles) >= 1, "no restore cycle")
        need(all(c["restored_windows_total"] > 0 and c["restore_lag_s"] is not None
                 for c in cycles), f"cycles {cycles}")
    return bad


def discovery_soak(card: str) -> dict:
    """Leg (b): the port's chaos soak (cli/chaos_soak.py) in each mode with
    --backend tpu, three daemons of the exact-tier deployment a mode, in a
    process of its own; each mode's JSON on a line of its own, held to the
    JAX tests' gates."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-soak-")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    docs = {}
    for mode, seconds in SOAK_MODES:
        path = os.path.join(out_dir, f"chaos_{mode}.json")
        t = time.monotonic()
        r = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cli.chaos_soak",
                            "--mode", mode, "--seconds", str(seconds), "--backend", "tpu",
                            "--json", path], cwd=root, env=env, capture_output=True,
                           text=True, timeout=seconds + 300)
        wall = time.monotonic() - t
        doc = json.load(open(path)) if os.path.exists(path) else {}
        emit(dict(phase="discovery", leg="soak", mode=mode, card=card, rc=r.returncode,
                  wall_s=wall, doc=doc))
        bad = _soak_gates(mode, doc)
        if r.returncode != 0 or bad or doc.get("backend") != "tpu":
            sys.stderr.write(r.stderr[-6000:])
            fail(f"discovery soak {mode}: exit {r.returncode}, gates failed: {bad}")
        docs[mode] = dict(wall_s=wall, doc=doc)
    return docs


def discovery_path(card: str) -> dict:
    """The discovery phase: legs (a) and (c) (the ring through etcd), then
    leg (b) (the soak's three modes)."""
    t0 = time.monotonic()
    ring = discovery_ring(card)
    soak = discovery_soak(card)
    seconds = time.monotonic() - t0
    summary = dict(
        seconds=seconds, budget_s=DISCOVERY_BUDGET_S, join_s=ring["join_s"],
        departure_s=ring["departure_s"], rejoin_s=ring["rejoin_s"],
        launches=ring["launches"],
        kill={k: soak["kill"]["doc"].get(k) for k in (
            "boot_s", "breaker_trip_s", "takeover_first_over_s", "recovery_s",
            "reconcile_lag_s", "drain_s", "error_rate", "faults_injected")},
        rolling=dict(keys_moved_total=soak["rolling"]["doc"].get("keys_moved_total"),
                     handoff_lag_max_s=soak["rolling"]["doc"].get("handoff_lag_max_s"),
                     canary_samples=soak["rolling"]["doc"].get("canary_samples"),
                     restarts=soak["rolling"]["doc"].get("restarts")),
        restore=[{k: c.get(k) for k in ("kill_to_serving_s", "respawn_to_serving_s",
                                        "restore_lag_s", "restored_windows_total")}
                 for c in soak["restore"]["doc"].get("cycles", [])],
    )
    emit(dict(phase="discovery", card=card, **summary))
    return dict(launches=ring["launches"], seconds=seconds)


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


def ablation_entry(step: str, ablation: dict, launches: int) -> dict:
    """The kernels line's entry for one ablation step: its numbers at the
    two-tier path's shape and kRows 8 (the product's chunk height), with
    every kRows and the script's shape beside them (that shape's store
    sits in L2: its bytes at the HBM rate and at the L2 copy rate this
    run measured, but no bound). `launches` is the step's count over the
    paths (0: it is on none). `launch` says how the kernel was launched:
    `deltas`' is a programmatic dependent launch ("pdl"), which overlaps
    the call before it; its `ms_no_overlap` and `share_of_bound_no_overlap`
    are the plain launch's, the ones that compare with the other steps."""
    main_rec = ablation["two_tier"]["steps"][f"{step}_K8"]
    overlap = {key: main_rec[key] for key in ("ms_no_overlap", "share_of_bound_no_overlap")
               if key in main_rec}
    return dict(
        name=f"writeback_ablation_{step}", route="cuda",
        source="gubernator_tpu_torch/csrc/writeback.cu",
        replaces="scripts/ablate_sweep.py:119", launches=launches, on_main_path=False,
        max_abs_err=max(r["steps"][f"{step}_K{k}"]["max_abs_err"]
                        for r in ablation.values() for k in (4, 8, 16)),
        ms=main_rec["ms"], plain_ms=main_rec["plain_ms"], bound_ms=main_rec["bound_ms"],
        bound_by="bytes", library_ms=main_rec["library_ms"], library=main_rec["library"],
        share_of_bound=main_rec["share_of_bound"], launch=main_rec["launch"], **overlap,
        shape=ablation["two_tier"]["shape"], krows=8,
        ms_by_shape_and_krows={shape: {k: r["steps"][f"{step}_K{k}"]["ms"] for k in (4, 8, 16)}
                               for shape, r in ablation.items()},
        script_shape_ms={key: ablation["script"]["steps"][f"{step}_K8"][key]
                         for key in ("ms", "hbm_bytes_ms", "l2_floor_ms")},
    )


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

    # the g++ builds (the edge, the hasher) run beside nvcc's, each its own
    # compiler, all at once
    from gubernator_tpu_torch.native import edge_build

    edge_res: dict = {}
    hasher_res: dict = {}

    def build_into(res: dict, build):
        t = time.monotonic()
        try:
            res["path"] = build()
        except Exception as e:  # reported, and failed on, by a later phase
            res["error"] = repr(e)
        res["seconds"] = time.monotonic() - t

    edge_thread = threading.Thread(target=build_into, args=(edge_res, edge_build.build),
                                   daemon=True)
    hasher_thread = threading.Thread(target=build_into,
                                     args=(hasher_res, edge_build.build_hasher), daemon=True)
    edge_thread.start()
    hasher_thread.start()

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
                     if "registers" in ln or "spill" in ln or "entry function" in ln]
              if log_path.exists() else []))
    hasher_thread.join()
    from gubernator_tpu_torch.core.hashing import using_native_hash

    if "error" in hasher_res or not using_native_hash():
        fail(f"build: the native hasher did not build or load: {hasher_res}")
    emit(dict(phase="build", path="hasher", library=hasher_res["path"].name,
              seconds=hasher_res["seconds"], xxh64=True))

    # 2. kernel vs plain at the paths' shapes ---------------------------------
    exact_cfg = derive_store_config(mib=1024)
    if (exact_cfg.rows, exact_cfg.slots) != (16, 1 << 21):
        fail(f"GUBER_STORE_MIB=1024 derived {exact_cfg}, not 2^21 x 16")
    two_cfg, _skc = derive_two_tier_config(1024)
    hash_phase(card, two_cfg.slots)
    ladder = buckets_for_limit(DEPTH)
    from gubernator_tpu_torch.cli.ablate_writeback import sleep_cycles_per_ms, spin_up

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
    floor = copy_floor_cases(cyc)
    for key, f in floor.items():
        emit(dict(phase="kernel", kernel="add_one", path=key, card=card, **f))
    # each writeback row's share of the measured floor at its store's size
    for path, key in (("exact", "1g"), ("sweep", "16m"), ("two_tier", "512m")):
        c = cases[path]
        c["floor_bytes_per_s"] = floor[key]["floor_bytes_per_s"]
        c["floor_by"] = floor[key]["floor_by"]
        c["floor_bound_ms"] = c["bytes_mean"] / c["floor_bytes_per_s"] * 1e3
        c["share_of_floor"] = c["floor_bound_ms"] / c["ms"]
    for path, c in cases.items():
        emit(dict(phase="kernel", kernel="writeback_add", path=path, card=card, **c))

    # the writeback ablation (its kernels are checked against their plain
    # versions inside, and fail the run on a difference)
    from gubernator_tpu_torch.cli import ablate_writeback

    t0 = time.monotonic()
    ablation = ablate_writeback.run()
    for shape, rec in ablation.items():
        emit(dict(phase="ablation", shape_key=shape, card=card, **rec))
    emit(dict(phase="ablation", summary_us=ablate_writeback.summary(ablation),
              seconds=time.monotonic() - t0))

    # 3-6. the paths, each with the launch count set to 0 before it ----------
    # the copy floor and the ablation: on no path, read at the end
    writeback.add_one.launches = 0
    writeback.writeback_rows.launches = writeback.writeback_deltas.launches = 0
    writeback.writeback_full.launches = 0
    exact = exact_path(card, ladder, writeback)
    two = two_tier_path(card, ladder, writeback)
    serving = serving_path(card, writeback, two["decisions_per_s"])
    doors = doors_path(card)
    cluster = cluster_path(card, writeback)
    edge_thread.join()
    geb = geb_path(card, edge_res)
    geb_checked = geb_checked_leg(card, writeback)
    chain = chain_path(card, ladder, writeback)
    durability = durability_path(card, ladder, writeback)
    workloads = workloads_path(card, writeback, doors["decisions_per_s"],
                               cluster["window"]["decisions_per_s"])
    discovery = discovery_path(card)
    floor_launches = writeback.add_one.launches
    if floor_launches:
        fail(f"the copy floor's kernel launched {floor_launches} times on the paths")
    ablation_launches = dict(rows=writeback.writeback_rows.launches,
                             deltas=writeback.writeback_deltas.launches,
                             full=writeback.writeback_full.launches)
    if any(ablation_launches.values()):
        fail(f"the ablation's kernels launched on the paths: {ablation_launches}")

    main_case, floor_case = cases["two_tier"], floor["512m"]
    emit({"kernels": [dict(
        name="writeback_add", route="cuda",
        source="gubernator_tpu_torch/csrc/writeback.cu",
        replaces="gubernator_tpu/core/pallas_sweep.py:97",
        launches=geb["launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=main_case["ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by="bytes",
        library_ms=main_case["library_ms"],
        share_of_floor=main_case["share_of_floor"], floor_by=main_case["floor_by"],
        launches_by_path={"exact": exact["launches"], "two_tier": two["launches"],
                          "serving": serving["launches"], "doors": doors["launches"],
                          "cluster": cluster["launches"], "geb": geb["launches"],
                          "geb_checked": geb_checked["launches"], "chain": chain["launches"],
                          "durability": durability["launches"],
                          "workloads": workloads["launches"],
                          "daemons": workloads["daemon_launches"],
                          "discovery": discovery["launches"]},
    ), dict(
        # the copy floor runs on no serving path: it measures the pass
        # over the store that bounds the writeback from below
        name="add_one", route="cuda",
        source="gubernator_tpu_torch/csrc/writeback.cu",
        replaces="scripts/bench_hbm.py:92",
        launches=floor_launches, on_main_path=False,
        max_abs_err=max(f["max_abs_err"] for f in floor.values()),
        ms=floor_case["ms"], plain_ms=floor_case["plain_ms"],
        bound_ms=floor_case["bound_ms"], bound_by="bytes",
        library_ms=floor_case["library_ms"],
        shape=floor_case["shape"], bytes_per_s=floor_case["bytes_per_s"],
        ms_by_shape={key: f["ms"] for key, f in floor.items()},
        library_ms_by_shape={key: f["library_ms"] for key, f in floor.items()},
    )] + [ablation_entry(step, ablation, ablation_launches[step]) for step in
          ("rows", "deltas", "full")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rpc-window"]:
        sys.exit(rpc_window_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--geb-window"]:
        sys.exit(geb_window_main(sys.argv[2:]))
    sys.exit(main())
