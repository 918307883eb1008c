"""The port's batch timeline (serve/stages.py) beside the device trace of a
traced slice: which host work each idle nanosecond of the card fell in,
and what the host threads were doing at the end of each long gap.

A timeline record is (name, start_ns, end_ns, thread, batch id), already
on the profiler's clock (`stages.wall_records`). Every function here runs
on plain lists, so the tests feed them recorded inputs.

Each idle nanosecond between the markers goes to one category, the first
of ORDER whose spans cover it:

    gc            inside a generation-2 collection, which holds the
                  interpreter lock: every Python thread, the submit
                  thread in its span too, stands still meanwhile
    submit        inside `submit_call` (the submit thread's whole body:
                  prep, merge, dispatch and its observe/launch/readback)
    fetch         inside `fetch_sync`, `unpack` (fetch threads) or
                  `resolve` (the loop setting the callers' futures)
    loop          inside `collect` or `promoter_tick`, or any other span
                  of a thread that recorded a `collect`
    unattributed  none of these

WAITS are left out everywhere: each times a wait (a group in the queue, a
batch from collect to its answers, the loop awaiting the submit or the
fetch thread), not a thread's own work.

These shares say which thread was busy while the card idled, not which
step held the card back: the submit thread is busy most of the time, so
it overlaps most idle time whatever paces the card. `attribute_paths`
follows the batch that ended each gap instead: the gap's end is the next
device work, issued inside a `launch` (or the top-k fold's `observe`) of
batch X, so each idle nanosecond goes to the step batch X was in at that
time (PATH): not yet collected (the loop elsewhere, e.g. returning from
batch X-1's submit), collecting (arrivals and the in-flight hold), handed
from the loop to the submit thread, or one step of X's submit body.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence, Tuple

from portbench import trace

Span = Tuple[int, int]

ORDER = ("gc", "submit", "fetch", "loop")
WAITS = frozenset(("batch_queue", "device", "submit_host", "fetch_wait"))
FETCH = frozenset(("fetch_sync", "unpack", "resolve"))
ROLE_OF = (("submit", "submit_call"), ("fetch", "fetch_sync"), ("loop", "collect"))
GRAPH_LAUNCH = "cudaGraphLaunch"
#: where the batch that ended a gap was, in the order a nanosecond is given
#: to them: a gen-2 collection first (it stops every thread), then the
#: steps of the batch's submit body innermost first, `after_launch` (the
#: launch had returned: the card started late), the rest of the body
#: (`submit_other`: dispatch's and submit_call's own code), the loop's
#: `collect`, the `handover` from collect's end to the submit body's start,
#: and `before_collect` (the loop had not begun collecting the batch)
PATH = ("gc", "observe", "launch", "after_launch", "merge", "prep", "submit_other", "collect",
        "handover", "before_collect")
#: gaps no decide batch ended: the slice's end, a promoter tick's install,
#: or no device-issuing span before the gap's end
NOT_A_BATCH = ("slice_end", "promoter_tick", "unknown")
ENDERS = frozenset(("launch", "observe", "promoter_tick"))


def union(spans: Iterable[Span]) -> List[Span]:
    """Sorted disjoint spans covering the same nanoseconds."""
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: Sequence[Span], b: Sequence[Span]) -> List[Span]:
    """The nanoseconds in both of two sorted disjoint span lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Span], b: Sequence[Span]) -> List[Span]:
    """The nanoseconds of `a` outside `b` (both sorted and disjoint)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < e:
            out.append((t, e))
    return out


def length(spans: Iterable[Span]) -> int:
    return sum(e - s for s, e in spans)


def threads_of(records) -> Dict[str, set]:
    """{role: the threads that recorded the role's marking span}."""
    return {role: {r[3] for r in records if r[0] == mark} for role, mark in ROLE_OF}


def category_spans(records) -> Dict[str, List[Span]]:
    """{category: the union of its spans}, for each of ORDER."""
    loop_threads = threads_of(records)["loop"]
    cats: Dict[str, list] = {c: [] for c in ORDER}
    for name, s, e, thread, _batch in records:
        if name in WAITS:
            continue
        if name == "submit_call":
            cats["submit"].append((s, e))
        elif name in FETCH:
            cats["fetch"].append((s, e))
        elif name == "gc":
            cats["gc"].append((s, e))
        elif name in ("collect", "promoter_tick") or thread in loop_threads:
            cats["loop"].append((s, e))
    return {c: union(v) for c, v in cats.items()}


def attribute(idle: Sequence[Span], records) -> Dict[str, int]:
    """{category: idle ns}: every nanosecond of the sorted disjoint `idle`
    spans in exactly one of ORDER + ("unattributed",)."""
    left = list(idle)
    out = {}
    for cat, spans in category_spans(records).items():
        got = intersect(left, spans)
        out[cat] = length(got)
        left = subtract(left, got)
    out["unattributed"] = length(left)
    return out


def gaps_by_span(idle: Sequence[Span], records, k: int = 10) -> List[list]:
    """[[name, seconds], ...] of the k longest idle gaps (as
    trace.named_gaps picks them), each named by the innermost span
    (the latest started) open at the gap's end on the submit, fetch and
    loop threads, e.g. "submit:launch loop:collect", and "gc" after them
    where a generation-2 collection ran inside the gap."""
    roles = threads_of(records)
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:k]
    out = []
    for a, b in gaps:
        parts = []
        for role, _mark in ROLE_OF:
            best = None
            for name, s, e, thread, _batch in records:
                if thread in roles[role] and name not in WAITS and s < b <= e:
                    if best is None or s > best[0]:
                        best = (s, name)
            if best is not None:
                parts.append(f"{role}:{best[1]}")
        if any(name == "gc" and s < b and e > a for name, s, e, *_ in records):
            parts.append("gc")
        out.append([" ".join(parts) or "no span", (b - a) / 1e9])
    return out


def _batch_steps(records) -> Dict[int, Dict[str, Span]]:
    """{batch id: {step: its first span}} for the steps PATH follows."""
    steps = ("collect", "submit_call", "prep", "merge", "observe", "launch")
    out: Dict[int, Dict[str, Span]] = {}
    for name, s, e, _thread, batch in records:
        if batch is not None and name in steps:
            out.setdefault(batch, {}).setdefault(name, (s, e))
    return out


def _enders(records) -> Tuple[List[int], List[tuple]]:
    """The records that may end a gap, by start: ([start], [(name, batch)])."""
    rows = sorted(((s, name, batch) for name, s, _e, _t, batch in records if name in ENDERS),
                  key=lambda r: r[0])
    return [r[0] for r in rows], [r[1:] for r in rows]


def gap_path(gap: Span, records, steps=None, enders=None, gcs=None,
             hi: int = None) -> Tuple[object, Dict[str, int]]:
    """(the batch id that ended `gap`, or one of NOT_A_BATCH; {PATH step:
    idle ns}), the ns summing to the gap's length. The ender is the latest
    `launch`, `observe` or `promoter_tick` record started before the gap's
    end; `steps`, `enders` and `gcs` may be passed in precomputed."""
    a, b = gap
    if steps is None:
        steps = _batch_steps(records)
    if enders is None:
        enders = _enders(records)
    if gcs is None:
        gcs = union((s, e) for name, s, e, _t, _b in records if name == "gc")
    starts, named = enders
    i = bisect.bisect_left(starts, b) - 1
    name, bid = named[i] if i >= 0 else ("", None)
    if hi is not None and b >= hi:
        bid = "slice_end"
    elif name == "promoter_tick" or bid not in steps:
        bid = "promoter_tick" if name == "promoter_tick" else "unknown"
    if bid in NOT_A_BATCH:
        got = intersect([(a, b)], gcs)
        out = {"gc": length(got)} if got else {}
        out[bid] = b - a - out.get("gc", 0)
        return bid, out
    st = steps[bid]
    sub = st.get("submit_call") or st.get("observe") or st["launch"]
    col = st.get("collect")
    cats = [
        ("gc", gcs),
        ("observe", [st["observe"]] if "observe" in st else []),
        ("launch", [st["launch"]] if "launch" in st else []),
        ("after_launch", [(st.get("launch", sub)[1], b)]),
        ("merge", [st["merge"]] if "merge" in st else []),
        ("prep", [st["prep"]] if "prep" in st else []),
        ("submit_other", [sub]),
        ("collect", [col] if col else []),
        ("handover", [(col[1], sub[0])] if col else []),
        ("before_collect", [(a, col[0] if col else sub[0])]),
    ]
    left, out = [(a, b)], {}
    for cat, spans in cats:
        got = intersect(left, union(spans))
        if got:
            out[cat] = length(got)
            left = subtract(left, got)
    if left:  # only where the recorded steps overlap out of order
        out["after_launch"] = out.get("after_launch", 0) + length(left)
    return bid, out


def attribute_paths(idle: Sequence[Span], records, hi: int = None,
                    k: int = 10) -> Tuple[Dict[str, int], List[dict]]:
    """({PATH or NOT_A_BATCH step: idle ns over every gap}, the k longest
    gaps as {batch, seconds, ms: {step: ms}}). The ns sum to the idle ns."""
    steps = _batch_steps(records)
    enders = _enders(records)
    gcs = union((s, e) for name, s, e, _t, _b in records if name == "gc")
    total = dict.fromkeys(PATH + NOT_A_BATCH, 0)
    paths = []
    for gap in idle:
        bid, got = gap_path(gap, records, steps, enders, gcs, hi)
        for cat, ns in got.items():
            total[cat] += ns
        paths.append((gap[1] - gap[0], bid, got))
    longest = sorted(paths, key=lambda p: -p[0])[:k]
    return total, [dict(batch=bid, seconds=n / 1e9,
                        ms={c: v / 1e6 for c, v in got.items()})
                   for n, bid, got in longest]


def launch_share(host, records, lo: int, hi: int, owners=("launch",),
                 slack_ns: int = 50_000) -> Tuple[float, int]:
    """(share, count) of the graph-launch runtime calls in [lo, hi] that
    fall inside a span named in `owners`, widened by `slack_ns` on each
    side: how well the timeline's clock lines up with the profiler's."""
    spans = union((s - slack_ns, e + slack_ns) for name, s, e, _t, _b in records
                  if name in owners)
    starts = [s for s, _e in spans]
    calls = [(s, e) for s, e, name, *_ in host if GRAPH_LAUNCH in name and lo <= s <= hi]
    inside = 0
    for s, e in calls:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and e <= spans[i][1]
    return (inside / len(calls) if calls else 0.0), len(calls)


def read_slice(records, dev, host, lo: int, hi: int) -> dict:
    """What a traced slice gains from the timeline: the records clipped to
    [lo, hi], the idle ns by category (`idle_by`, which sums to the
    slice's idle ns), the 10 longest gaps named by span, and the share of
    graph launches inside `launch` spans (and inside any span that
    launches a graph: the decide's `launch`, the top-k fold's `observe`,
    the promoter's installs under `promoter_tick`); and the idle ns along
    the path of the batch that ended each gap (`idle_by_path`, also
    summing to the idle ns) with the 10 longest gaps so split."""
    idle = trace.idle_gaps(dev, lo, hi)
    kept = [r for r in records if r[2] > lo and r[1] < hi]
    share, calls = launch_share(host, kept, lo, hi)
    owned, _ = launch_share(host, kept, lo, hi, owners=("launch", "observe", "promoter_tick"))
    # the batch steps are looked up in every record: a batch's collect
    # may have begun before the slice
    by_path, gaps_by_path = attribute_paths(idle, records, hi)
    return dict(
        timeline=kept,
        idle_ns=length(idle),
        idle_by=attribute(idle, kept),
        idle_by_path=by_path,
        idle_gaps_by_path=gaps_by_path,
        idle_gaps_by_span=gaps_by_span(idle, kept),
        graph_launches=calls,
        launch_share=share,
        graph_owned_share=owned,
    )
