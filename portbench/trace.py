"""Device time from a torch.profiler run: the union of the device's
intervals (kernels, copies, memsets) over a traced window, the idle gaps
between them, and the breakdown the result line carries. The profile is
reduced to plain lists first (`events_of`), so every function below runs
on recorded inputs too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int, str]  # (start_ns, end_ns, name)


def events_of(prof, mark: str):
    """(device intervals, host runtime calls as (start, end, name,
    correlation id), the (start, end) of the host range named `mark`) of
    a finished torch.profiler run, all on the profiler's clock."""
    dev, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if "CUDA" in kind:
            dev.append((start, end, e.name()))
        elif e.name() == mark:
            span = (start, end)
        elif e.correlation_id():
            host.append((start, end, e.name(), int(e.correlation_id())))
    return dev, host, span


def merged(intervals: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the intervals clipped to [lo, hi], as sorted disjoint spans."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in intervals if e > lo and s < hi)
    out: List[List[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals: List[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which at least one device interval ran."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def idle_gaps(intervals: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The spans of [lo, hi] in which the device ran nothing."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def top_ops(intervals: List[Interval], lo: int, hi: int, k: int = 10) -> List[list]:
    """[[name, seconds], ...] of the k device operations with most time."""
    tot: Dict[str, int] = {}
    for s, e, name in intervals:
        if e > lo and s < hi:
            tot[name] = tot.get(name, 0) + min(e, hi) - max(s, lo)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:120], v / 1e9] for n, v in best]


def named_gaps(intervals: List[Interval], host, lo: int, hi: int, k: int = 10) -> List[list]:
    """[[name, seconds], ...] of the k longest idle gaps, each named by the
    host call the device waited for: the runtime call that started last
    before the gap ended (the launch or copy that ended it), or the
    host's call spanning the gap's end."""
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:k]
    calls = sorted(host)
    out = []
    for a, b in gaps:
        name: Optional[str] = None
        for s, _e, n, _c in calls:
            if s > b:
                break
            name = n
        out.append([f"host: {name or 'no runtime call'}"[:120], (b - a) / 1e9])
    return out


def reduce(dev: List[Interval], host, lo: int, hi: int) -> dict:
    """Everything the readers and the result line take from one trace."""
    busy = busy_ns(dev, lo, hi)
    return dict(
        window_ns=hi - lo,
        busy_ns=busy,
        idle_share=1.0 - busy / (hi - lo) if hi > lo else None,
        device_ops=top_ops(dev, lo, hi),
        idle_gaps=named_gaps(dev, host, lo, hi),
        events=sum(1 for s, e, _ in dev if e > lo and s < hi),
    )
