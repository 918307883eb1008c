"""The writeback ablation on the card: which step of the writeback costs
the time (the port of scripts/ablate_sweep.py).

    python -m gubernator_tpu_torch.cli.ablate_writeback [--shape script|two_tier|all]

The TPU script timed three modes of the Pallas store sweep (the tile
copy, plus the chunk DMA, plus the one-hot matmul) at several TILE_ROWS.
The Hopper writeback has none of those mechanics, so this asks the same
question of it, with three exactly defined steps (core/writeback.py,
kernels in csrc/writeback.cu), each at the kernels' chunk (for `full`,
tile) heights kRows in {4, 8, 16} (the product runs 8; the counterpart of
the script's TILE_ROWS sweep):

- `rows`: the store side, each touched store row loaded and stored back
  plus one in every int32 (the +1 makes the store observable, so the
  check against the plain version catches a row skipped, doubled or
  misplaced; the bytes are those of a load and a store);
- `deltas`: the delta stream, every delta row and bucket id read and each
  run of equal buckets within a chunk summed into its last row;
- `full`: writeback_add's function (`writeback_full`).

Each kernel is first held bit for bit against its plain PyTorch version
on the same inputs, then timed: ms, plain_ms and library_ms (`LIBRARY`
names the one PyTorch call of each step) are device time per call of a
run of back-to-back calls cycling through the shape's batches (CUDA
events around the run, a sleep queued ahead of it so that
the host's launch gaps stay outside it; a call that waits on the host,
named in `waits_on_host` (found by CUDA's sync debug mode, or by a run
the card reached before the host had queued it), is timed from a drained
card, its waits included). Every kernel launches as a plain stream
launch except `deltas`'s, a programmatic dependent launch whose start
overlaps the end of the call before it (`launch` in each record says
which): its `ms_no_overlap` is the same kernel launched plainly, timed in
the same turns, which is the time that compares with the other steps'.
Two shapes:

- `script`: the script's own, int32[32768, 128] with B = 16,384 sorted
  bucket ids (seed 5). Its 16 MiB store fits in the H100's 50 MB L2, so
  its times are L2 times, not HBM times. The card has no published L2
  rate, so this shape has no bound_ms: `hbm_bytes_ms` is its bytes at
  the HBM rate (which an L2-resident step may beat), and `l2_floor_ms`
  its bytes at the copy rate this run measures over the same 16 MiB
  store (the fastest of add_one and x.add_(1));
- `two_tier`: the two-tier path's, 2^20 buckets and the group stream of a
  zipf(1.2) batch of 32,768 over 100M keys, cycling 8 batches; bound_ms
  is the step's bytes over the H100's 3.35 TB/s of HBM.

At the two-tier shape each step at kRows 8 is also timed over its first
batch alone, repeated (`one_set_vs_all`): one batch's 8 MB stay in the
L2, so the pair tells a step held back by cold HBM reads from one held
back by its own design.

Prints, last, one JSON object of microseconds per call, keyed
`<shape>_<step>_K<kRows>` as the script keyed `T<rows>_<mode>`; with
`--detail`, one JSON line per shape before it with every number. Needs a
CUDA device; builds the kernels with nvcc at first use.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from gubernator_tpu_torch.core.writeback import (
    ABLATION_ROWS,
    add_one,
    run_ends,
    writeback_add_plain,
    writeback_deltas,
    writeback_deltas_plain,
    writeback_full,
    writeback_rows,
    writeback_rows_plain,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
W = 128
CALLS = 192  # calls per timed run
STEPS = ("rows", "deltas", "full")
#: the one PyTorch call that computes each step's function (library_ms)
LIBRARY = {
    "rows": "index_add_ of ones over the touched buckets",
    "deltas": "index_add_ of the delta rows onto run_ends(bkt, krows), the ends "
              "computed ahead",
    "full": "index_add_",
}


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


class UncoveredRun(RuntimeError):
    """The card reached a run before the host had queued all of it."""


def waits_on_host(fn) -> bool:
    """Whether one call of `fn` synchronises with the card (a device-to-
    host read inside it), found by CUDA's sync debug mode."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def run_ms(calls: list, cycles_per_ms: float, n: int = CALLS,
           host_waits: bool = False) -> float:
    """Device ms per call of `n` back-to-back calls cycling through
    `calls`, with a sleep queued ahead of the start event that outlasts
    the host's enqueueing (retried longer if the card got there first).
    Calls that wait on the host (`waits_on_host`) cannot be queued ahead
    of the card: their run is timed from a drained card, host waits
    included."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    if host_waits:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            calls[i % len(calls)]()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
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
    raise UncoveredRun("run_ms: the host never enqueued a run before the card reached it")


def script_shape(device="cuda"):
    """scripts/ablate_sweep.py's inputs, drawn as it draws them: the store,
    the sorted bucket ids and the delta half of its combined rows.
    Returns (name, store tensor on `device`, [(bkt, drow) numpy],
    whether the store sits in L2)."""
    buckets, B = 1 << 15, 16384
    rng = np.random.default_rng(5)
    data = rng.integers(-2**31, 2**31 - 1, (buckets, W), dtype=np.int64).astype(np.int32)
    bkt = np.sort(rng.integers(0, buckets, B)).astype(np.int32)
    drow = rng.integers(-1000, 1000, (B, W)).astype(np.int32)
    name = "script: int32[32768, 128], B=16384 sorted ids (seed 5), in the 50 MB L2"
    return name, torch.from_numpy(data).to(device), [(bkt, drow)], True


def two_tier_shape(device="cuda", sets: int = 8, depth: int = 32768,
                   buckets: int = 1 << 20):
    """The two-tier path's writeback: 2^20 buckets and the padded group
    stream of zipf(1.2) batches over 100M keys (the repo's key recipe,
    gubernator_tpu/cli/keystreams.py), delta rows over all of int32 with
    30% zero rows (non-writers)."""
    from gubernator_tpu_torch.core.engine import buckets_for_limit, pad_request_sorted
    from gubernator_tpu_torch.core.store import group_sort_key_np

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=device).manual_seed(3)
    data = torch.randint(-2**31, 2**31 - 1, (buckets, W), dtype=torch.int32,
                         device=device, generator=gen)
    out = []
    for s in range(sets):
        ids = np.random.default_rng(7 + s).zipf(1.2, depth) % 100_000_000
        kh = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(
            0xDEADBEEFCAFEF00D)
        ones = np.ones(depth, np.int64)
        _req, _order, groups = pad_request_sorted(
            buckets_for_limit(depth), buckets, kh, ones, ones, ones,
            np.zeros(depth, np.int32), np.zeros(depth, bool), with_groups=True)
        bkt = (group_sort_key_np(groups.key_hash, buckets) >> np.uint64(32)).astype(np.int32)
        drow = rng.integers(-2**31, 2**31 - 1, (bkt.shape[0], W), dtype=np.int64).astype(np.int32)
        drow[rng.random(bkt.shape[0]) < 0.3] = 0
        out.append((bkt, drow))
    return (f"two-tier path: {buckets} buckets, G of a zipf100m batch of {depth}, "
            f"{sets} batches"), data, out, False


def step_bytes(step: str, bkt: torch.Tensor, krows: int) -> int:
    """The bytes the step must move: each input read once, each output
    written once, counted on this batch's own runs."""
    G = bkt.shape[0]
    U = int(torch.unique_consecutive(bkt).shape[0])
    if step == "rows":
        return 2 * U * W * 4 + G * 4
    if step == "deltas":
        Uc = int(torch.unique_consecutive(run_ends(bkt, krows)).shape[0])
        return G * W * 4 + G * 4 + Uc * W * 4
    return G * W * 4 + G * 4 + 2 * U * W * 4


def _segment_reduce(drow: torch.Tensor, lengths: torch.Tensor):
    return torch.segment_reduce(drow, "sum", lengths=lengths)


def deltas_library(out: torch.Tensor, ends: torch.Tensor, drow: torch.Tensor) -> torch.Tensor:
    """The deltas step as one PyTorch call, given `ends = run_ends(bkt,
    krows)` (found ahead of the timed run, as the rows step finds its
    touched buckets): out[ends[i]] += drow[i], in place."""
    return out.index_add_(0, ends, drow)


def measure(shape, cyc: float) -> dict:
    """Every step at every kRows on one shape: checked, then timed."""
    name, data, sets_np, in_l2 = shape
    sets = [(torch.from_numpy(b).cuda(), torch.from_numpy(d).cuda()) for b, d in sets_np]
    bkt0, drow0 = sets[0]
    work = data.clone()
    outs = [torch.zeros_like(d) for _, d in sets]
    rec = dict(shape=name, buckets=int(data.shape[0]), G=int(bkt0.shape[0]),
               touched_rows=int(torch.unique_consecutive(bkt0).shape[0]), sets=len(sets),
               calls_per_run=CALLS, steps={})
    # a note on the library's own segmented sum, which would be the natural
    # yardstick but has no int32 kernel in the builds tried so far
    lengths = torch.unique_consecutive(run_ends(bkt0, 8), return_counts=True)[1]
    try:
        _segment_reduce(drow0, lengths)
        seg_lib = None
    except (RuntimeError, NotImplementedError) as e:
        seg_lib = f"torch.segment_reduce on int32 raised: {str(e).splitlines()[0]}"
    # the deltas step's library call scatters onto each row's run end
    ends = {k: [run_ends(b, k) for b, _ in sets] for k in ABLATION_ROWS}
    # the library's rows step: one index_add_ of ones over each set's
    # touched buckets (found ahead of the timed run)
    touched = [torch.unique_consecutive(b) for b, _ in sets]
    ones = [torch.ones(u.shape[0], W, dtype=torch.int32, device=u.device) for u in touched]
    if in_l2:
        # the copy rate over this store, in L2: the floor of the script's shape
        spin_up(0.2)
        store_bytes = 2 * data.numel() * 4
        copy_ms = {"add_one": min(run_ms([lambda: add_one(work)], cyc) for _ in range(3)),
                   "x.add_(1)": min(run_ms([lambda: work.add_(1)], cyc) for _ in range(3))}
        floor_by = min(copy_ms, key=copy_ms.get)
        l2_bytes_per_s = store_bytes / (copy_ms[floor_by] * 1e-3)
        rec.update(l2_copy_ms=copy_ms, l2_floor_by=floor_by, l2_bytes_per_s=l2_bytes_per_s)
    for step in STEPS:
        for k in ABLATION_ROWS:
            # 1. bit for bit against the plain version on the first batch
            if step == "rows":
                got = writeback_rows(data.clone(), bkt0, k)
                want = writeback_rows_plain(data.clone(), bkt0)
                ok = torch.equal(got, want)
            elif step == "deltas":
                got = writeback_deltas(torch.zeros_like(drow0), bkt0, drow0, k)
                want = writeback_deltas_plain(torch.zeros_like(drow0), bkt0, drow0, k)
                plain_launch = writeback_deltas(torch.zeros_like(drow0), bkt0, drow0, k,
                                                overlap=False)
                ok = torch.equal(got, want) and torch.equal(plain_launch, want)
                del plain_launch
            else:
                got = writeback_full(data.clone(), bkt0, drow0, k)
                want = writeback_add_plain(data.clone(), bkt0, drow0)
                ok = torch.equal(got, want)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max().item())
            if not ok or err:
                raise AssertionError(f"{name}: {step} K{k} disagrees with its plain "
                                     f"version (max abs err {err})")
            del got, want
            # 2. timed, cycling through the batches
            if step == "rows":
                fns = dict(ms=[lambda b=b: writeback_rows(work, b, k) for b, _ in sets],
                           plain_ms=[lambda b=b: writeback_rows_plain(work, b)
                                     for b, _ in sets],
                           library_ms=[lambda u=u, o=o: work.index_add_(0, u, o)
                                       for u, o in zip(touched, ones)])
            elif step == "deltas":
                fns = dict(ms=[lambda b=b, d=d, o=o: writeback_deltas(o, b, d, k)
                               for (b, d), o in zip(sets, outs)],
                           ms_no_overlap=[lambda b=b, d=d, o=o: writeback_deltas(
                               o, b, d, k, overlap=False) for (b, d), o in zip(sets, outs)],
                           plain_ms=[lambda b=b, d=d, o=o: writeback_deltas_plain(o, b, d, k)
                                     for (b, d), o in zip(sets, outs)],
                           library_ms=[lambda e=e, d=d, o=o: deltas_library(o, e, d)
                                       for (_, d), o, e in zip(sets, outs, ends[k])])
            else:
                fns = dict(ms=[lambda b=b, d=d: writeback_full(work, b, d, k)
                               for b, d in sets],
                           plain_ms=[lambda b=b, d=d: writeback_add_plain(work, b, d)
                                     for b, d in sets],
                           library_ms=[lambda b=b, d=d: work.index_add_(0, b, d)
                                       for b, d in sets])
            waits = {key: waits_on_host(f[0]) for key, f in fns.items()}
            spin_up(0.2)
            samples = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1], list(fns), list(fns)[::-1]):
                for key in order:
                    try:
                        t = run_ms(fns[key], cyc, host_waits=waits[key])
                    except UncoveredRun:
                        if key == "ms":  # a kernel launch never waits on the host
                            raise UncoveredRun(f"{name}: {step} K{k}: the kernel's "
                                               "run was never queued ahead of the card")
                        # a plain or library call that waits on the host in a
                        # way the sync debug mode does not see
                        waits[key] = True
                        t = run_ms(fns[key], cyc, host_waits=True)
                    samples[key].append(t)
            times = {key: statistics.median(v) for key, v in samples.items()}
            nbytes = float(np.mean([step_bytes(step, b, k) for b, _ in sets]))
            hbm_ms = nbytes / HBM_BYTES_PER_S * 1e3
            entry = dict(
                step=step, krows=k, max_abs_err=err, bytes_mean=nbytes,
                launch="pdl" if step == "deltas" else "stream",
                ms=times["ms"], ms_no_overlap=times.get("ms_no_overlap"),
                plain_ms=times["plain_ms"],
                library_ms=times["library_ms"], library=LIBRARY[step],
                # a note: why the library's own segmented sum is not the yardstick
                library_none_because=(seg_lib if step == "deltas" and k == 8 else None),
                waits_on_host=[key for key, w in waits.items() if w],
                ms_samples=samples["ms"])
            if in_l2:
                l2_ms = nbytes / l2_bytes_per_s * 1e3
                entry.update(bound_ms=None, bound_none_because="the store sits in L2, "
                             "whose rate the card does not publish", hbm_bytes_ms=hbm_ms,
                             l2_floor_ms=l2_ms, share_of_l2_floor=l2_ms / times["ms"])
            else:
                entry.update(bound_ms=hbm_ms, bound_by="bytes",
                             share_of_bound=hbm_ms / times["ms"])
                if "ms_no_overlap" in times:
                    entry["share_of_bound_no_overlap"] = hbm_ms / times["ms_no_overlap"]
            rec["steps"][f"{step}_K{k}"] = entry
            if k == 8 and len(sets) > 1:
                # the first batch alone, repeated (its rows stay in the L2),
                # in turns with the run over every batch
                pair = {"one": [], "all": []}
                for _ in range(2):
                    pair["one"].append(run_ms(fns["ms"][:1], cyc))
                    pair["all"].append(run_ms(fns["ms"], cyc))
                    pair["all"].append(run_ms(fns["ms"], cyc))
                    pair["one"].append(run_ms(fns["ms"][:1], cyc))
                one, every = (statistics.median(pair[key]) for key in ("one", "all"))
                rec.setdefault("one_set_vs_all", {})[step] = dict(
                    krows=k, sets=len(sets), ms_one_set=one, ms_all_sets=every,
                    all_over_one=every / one)
    del data, work, sets, outs, touched, ones, ends
    torch.cuda.empty_cache()
    return rec


SHAPES = {"script": script_shape, "two_tier": two_tier_shape}


def run(shapes=("script", "two_tier")) -> dict:
    """{shape key: measure(...)} on the current card."""
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device (the kernels have no CPU mode)")
    spin_up()
    cyc = sleep_cycles_per_ms()
    return {key: measure(SHAPES[key](), cyc) for key in shapes}


def summary(results: dict) -> dict:
    """The script's JSON: microseconds per call, keyed shape_step_K<rows>."""
    return {f"{shape}_{key}": round(s["ms"] * 1e3, 3)
            for shape, rec in results.items() for key, s in rec["steps"].items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", choices=("script", "two_tier", "all"), default="all")
    parser.add_argument("--detail", action="store_true",
                        help="print every number of each shape first")
    args = parser.parse_args(argv)
    try:
        results = run(tuple(SHAPES) if args.shape == "all" else (args.shape,))
    except (RuntimeError, AssertionError) as e:
        print(f"ablate_writeback: {e}", file=sys.stderr)
        return 1
    if args.detail:
        for rec in results.values():
            print(json.dumps(rec))
    print(json.dumps(summary(results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
