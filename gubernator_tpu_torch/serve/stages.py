"""Stage-attribution clock for the serving pipeline.

The port's copy of gubernator_tpu/serve/stages.py with its imports
rewritten; the file references below are the reference package's.

Round 5's verdict called the served front door "admitted blind": the
device trace sees inside a batch, Prometheus sees per-RPC totals, but
nothing said WHERE a served decision's wall time went between the edge
socket and the response write. This module is that decomposition: a
process-global accumulator of per-stage monotonic spans, recorded at
six fixed points of the serving path and exposed as
`/v1/debug/stages` (serve/server.py) plus the
`scripts/profile_serving_stages.py` artifact.

Stages form two families:

- **per-frame stages** (`PER_FRAME`): spans that tile one edge frame's
  end-to-end wall time, so their totals are directly comparable to the
  frame e2e total. Coverage = sum(per-frame stage seconds) / e2e
  seconds; the gap is unattributed time (event-loop scheduling, frame
  reads) and should stay under ~10%.

    edge_to_bridge   frame send stamp (edge, CLOCK_MONOTONIC us) ->
                     frame fully read by the bridge. Windowed frames
                     only; monotonic epochs differ across hosts, so
                     the bridge calibrates each connection against the
                     smallest delta it has seen (epoch offset + floor
                     transit) and attributes time spent ABOVE that
                     floor: window queueing + socket backlog.
    bridge_decode    frame payload -> numpy fields / request objects
    shed             over-limit shed-cache screen of the frame's items
                     (serve/shedcache.py, r10) — the host-side answer
                     path for frozen token-bucket refusals. Items it
                     sheds never enqueue; a fully-shed frame has no
                     batch_queue/device span at all, and this stage is
                     what tiles that part of its e2e (the frame-
                     coverage contract keeps no hole)
    batch_queue      batcher enqueue -> flusher collect (per group)
    device           flusher collect -> responses resolved (per group;
                     covers submit + device execute + fetch + any wait
                     behind earlier pipelined batches)
    encode           responses resolved -> response frame written

- **per-batch stages** (`PER_BATCH`): the batcher's submit/wait split,
  recorded once per device batch. They do NOT tile frame e2e (one
  batch serves many frames) but attribute the `device` span's
  interior: host submit (presort + dispatch) vs device fetch wait.
  The r9 host-prep pipeline splits submit_host's interior further:
  prep + merge + dispatch tile the submit_call body (submit_host
  additionally includes the submit-executor queue wait, so it can
  exceed their sum). None of these enter per-frame coverage — the
  r7 contract (frame-flagged groups only) is untouched.

    submit_host      decide_submit* call on the submit thread
                     (admission -> handle, incl. executor queueing)
    prep             submit-thread group prep: flush-time fallback
                     conversion/presort of un-prepped groups, plus
                     waiting out arrival preps that hadn't finished
                     (~0 when GUBER_PREP_AT_ARRIVAL keeps up)
    merge            k-way merge of the groups' pre-sorted runs into
                     one sorted batch (serve/prep.py); absent on the
                     flush-time baseline path, whose full argsort
                     hides inside dispatch
    dispatch         backend decide_submit_presorted/_arrays call:
                     pad + group-derive + device dispatch
    fetch_wait       decide_wait* span on the fetch pool

- **per-call stages** (`PER_CALL`): recorded once per
  Instance.get_rate_limits call from ANY front door (gRPC/HTTP/string
  frames) — not tied to edge frames or device batches at all.

    instance_route   instance-side validation/routing/assembly
                     (excluded from the fold and fast paths, which
                     bypass the instance)

Everything is a plain float accumulation under one lock — ~0.5us per
record — so the clock can stay on in production. `/metrics` exports
the same totals as gauges (serve/metrics.py stage_seconds_total).

The chain lane (r15) participates in BOTH families like the decide
lanes (r16 audit fix): a frame-flagged chained group records
batch_queue and device spans, and the serialized chain call records
submit_host on the submit thread — before this, chained traffic added
frame e2e with no per-frame stages and silently diluted coverage.

Tracing tie-in (r16, serve/tracing.py): when the caller's context
carries an active trace, `add` forwards the same span into it — the
distributed tracer reuses these timings instead of running a second
clock. One ContextVar read per record when tracing is idle.

The port's batch timeline. The totals say how long each stage took, not
when it ran, on which thread or for which batch. `arm_timeline(capacity)`
preallocates a bounded list; while it is armed every `add` also keeps
(name, start_ns, end_ns, thread name, batch id) on the monotonic clock,
and counts `dropped` once the list is full. `disarm_timeline()` returns
the records with a (monotonic_ns, time_ns) pair read at arm and one at
disarm, which map the records onto another clock (the torch profiler's
timestamps are Unix-epoch nanoseconds). Disarmed, a record pays one
attribute check more. No setting arms it: an operator has no switch
(no environment variable, no config field); the benchmark and the tests
arm it by call.

The timeline's own stages, recorded only by the port (each through
`add`, so each is in the totals too: `/v1/debug/stages` lists them under
`per_batch_stages` and `per_tick_stages`, and `/metrics` exports them in
`serving_stage_seconds_total{stage}`; `batch` is the batcher's id of the
device batch, carried to the threads that work on it). The pipelined
decide paths record all of them; the chain lane and the non-pipelined
backends record `collect` alone:

    collect          the flusher's loop top -> collect_batch returned
                     (incl. the deep-batch hold); assigns the batch id
    submit_call      the whole submit-thread body (parent of prep,
                     merge, dispatch)
    observe          the engine's hot-key observer call (dispatch child)
    launch           staging pack, upload and replay (or the eager
                     programs) (dispatch child)
    readback         pinned output buffer, D2H copy call, event record
                     (dispatch child)
    fetch_sync       the fetch thread's wait on the batch's copy event
    unpack           after the wait: numpy view, stats, unpermute
    resolve          the loop slicing answers and setting the futures
                     (on the request-object path its batch metrics too)
    promoter_tick    one SketchPromoter.flush_once (no batch)
    store_size       the backend's count of the store's occupied entries
                     for `stats()` (a `/metrics` scrape's `cache_size`):
                     its device reads and sync, in the caller's thread
                     (no batch)
    gc               a generation-2 collection while the timeline is
                     armed (no batch; reaches the totals at disarm)
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.serve import tracing

PER_FRAME = (
    "edge_to_bridge",
    "bridge_decode",
    "shed",
    "batch_queue",
    "device",
    "encode",
)
PER_BATCH = ("submit_host", "prep", "merge", "dispatch", "fetch_wait",
             "collect", "submit_call", "observe", "launch", "readback",
             "fetch_sync", "unpack", "resolve")
PER_CALL = ("instance_route",)
#: recorded on their own clock, tied to no batch or frame
PER_TICK = ("promoter_tick", "gc", "store_size")


def clock_pair() -> Tuple[int, int]:
    """(time.monotonic_ns(), time.time_ns()) read together: the wall
    reading between two monotonic ones, paired with their midpoint."""
    m0 = time.monotonic_ns()
    w = time.time_ns()
    m1 = time.monotonic_ns()
    return (m0 + m1) // 2, w


class _Timeline:
    """The armed timeline: a preallocated list of records filled in
    order, the count that found it full, and the gen-2 collections."""

    __slots__ = ("records", "n", "dropped", "arm", "gc_spans", "gc_t0")

    def __init__(self, capacity: int):
        self.records: List[Optional[tuple]] = [None] * int(capacity)
        self.n = 0
        self.dropped = 0
        self.arm = clock_pair()
        self.gc_spans: list = []
        self.gc_t0 = None

    def put(self, rec: tuple) -> None:
        if self.n < len(self.records):
            self.records[self.n] = rec
            self.n += 1
        else:
            self.dropped += 1

    def on_gc(self, phase, info) -> None:
        """gc.callbacks hook. It takes no lock (a collection may start
        inside a locked `add`); its spans join the records at disarm."""
        if info.get("generation") != 2:
            return
        if phase == "start":
            self.gc_t0 = time.monotonic_ns()
        elif self.gc_t0 is not None:
            self.gc_spans.append(
                (self.gc_t0, time.monotonic_ns(), threading.current_thread().name)
            )
            self.gc_t0 = None


class StageStats:
    """Cumulative per-stage spans + frame end-to-end totals."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, Tuple[float, int]] = {}
        self._e2e_s = 0.0
        self._frames = 0
        self._started = time.monotonic()
        self._timeline: Optional[_Timeline] = None
        self._local = threading.local()

    def add(
        self,
        stage: str,
        seconds: float,
        n: int = 1,
        end: Optional[float] = None,
        batch: Optional[int] = None,
    ) -> None:
        """One span of `stage` that lasted `seconds` and ended at `end`
        (time.monotonic seconds; now by default). `batch` is the device
        batch's id, else the one this thread is bound to (bind_batch);
        both matter only to an armed timeline."""
        if seconds < 0:  # clock skew guard (edge stamp from the future)
            return
        tr = tracing.active()
        if tr is not None:
            # the span ended at `end` and lasted `seconds`: the trace
            # gets the stage clock's own timing, not a parallel
            # measurement
            tr.add_span(stage, duration_s=seconds, end=end)
        with self._lock:
            total, count = self._stages.get(stage, (0.0, 0))
            self._stages[stage] = (total + seconds, count + n)
            tl = self._timeline
            if tl is not None:
                # a record of n spans (the per-frame stages) keeps their
                # mean. The start is taken in seconds first: a span
                # timed as t1 - t0 then starts at exactly t0, as its
                # parent or sibling from t0 does
                end_s = time.monotonic() if end is None else end
                tl.put((
                    stage, round((end_s - seconds / max(n, 1)) * 1e9), round(end_s * 1e9),
                    threading.current_thread().name,
                    getattr(self._local, "batch", None) if batch is None else batch,
                ))

    def bind_batch(self, batch: Optional[int]) -> None:
        """Tag this thread's next spans with device batch `batch` (None
        unbinds): the engine's spans on the submit and fetch threads
        carry the batcher's id this way."""
        self._local.batch = batch

    def arm_timeline(self, capacity: int) -> None:
        """Start keeping every span's record, up to `capacity` of them,
        and time the gen-2 collections meanwhile. Arming an armed
        timeline starts it afresh."""
        tl = _Timeline(capacity)
        with self._lock:
            old, self._timeline = self._timeline, tl
        if old is not None:
            gc.callbacks.remove(old.on_gc)
        gc.callbacks.append(tl.on_gc)

    def disarm_timeline(self) -> Optional[dict]:
        """Stop keeping records; returns {records: [(name, start_ns,
        end_ns, thread, batch)] on the monotonic clock, dropped, arm,
        disarm: (monotonic_ns, time_ns) pairs}, or None if not armed.
        The collections timed meanwhile join the records and the totals
        as `gc` spans."""
        with self._lock:
            tl, self._timeline = self._timeline, None
        if tl is None:
            return None
        gc.callbacks.remove(tl.on_gc)
        disarm = clock_pair()
        records = tl.records[: tl.n]
        for s, e, thread in tl.gc_spans:
            self.add("gc", (e - s) / 1e9, end=e / 1e9)
            records.append(("gc", s, e, thread, None))
        return dict(records=records, dropped=tl.dropped, arm=tl.arm, disarm=disarm)

    def add_frame(self, e2e_seconds: float) -> None:
        """One edge frame fully served (edge send stamp when the frame
        carried one, else bridge read start -> response written). The
        denominator of per-frame stage coverage."""
        if e2e_seconds < 0:
            return
        with self._lock:
            self._e2e_s += e2e_seconds
            self._frames += 1

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._e2e_s = 0.0
            self._frames = 0
            self._started = time.monotonic()

    def snapshot(self) -> dict:
        with self._lock:
            stages = {
                name: {
                    "total_s": round(total, 6),
                    "count": count,
                    "mean_ms": round(total / count * 1e3, 4)
                    if count
                    else 0.0,
                }
                for name, (total, count) in sorted(self._stages.items())
            }
            e2e_s, frames = self._e2e_s, self._frames
            window_s = time.monotonic() - self._started
        attributed = sum(
            s["total_s"] for n, s in stages.items() if n in PER_FRAME
        )
        return {
            "stages": stages,
            "per_frame_stages": list(PER_FRAME),
            "per_batch_stages": list(PER_BATCH),
            "per_call_stages": list(PER_CALL),
            "per_tick_stages": list(PER_TICK),
            "frames": frames,
            "frame_e2e_total_s": round(e2e_s, 6),
            "attributed_total_s": round(attributed, 6),
            "coverage": round(attributed / e2e_s, 4) if e2e_s else 0.0,
            "window_s": round(window_s, 3),
        }


def wall_records(timeline: dict) -> list:
    """The records of a disarmed timeline (disarm_timeline's dict) with
    their times moved onto time.time_ns's clock, the torch profiler's:
    linear through the arm and disarm pairs."""
    (m0, w0), (m1, w1) = timeline["arm"], timeline["disarm"]
    scale = (w1 - w0) / (m1 - m0) if m1 > m0 else 1.0

    def wall(t: int) -> int:
        return w0 + round((t - m0) * scale)

    return [(name, wall(s), wall(e), thread, batch)
            for name, s, e, thread, batch in timeline["records"]]


#: process-global clock; the bridge, batcher, and instance record here
STAGES = StageStats()
