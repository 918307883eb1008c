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
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

from gubernator_tpu_torch.serve import tracing

PER_FRAME = (
    "edge_to_bridge",
    "bridge_decode",
    "shed",
    "batch_queue",
    "device",
    "encode",
)
PER_BATCH = ("submit_host", "prep", "merge", "dispatch", "fetch_wait")
PER_CALL = ("instance_route",)


class StageStats:
    """Cumulative per-stage spans + frame end-to-end totals."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, Tuple[float, int]] = {}
        self._e2e_s = 0.0
        self._frames = 0
        self._started = time.monotonic()

    def add(self, stage: str, seconds: float, n: int = 1) -> None:
        if seconds < 0:  # clock skew guard (edge stamp from the future)
            return
        tr = tracing.active()
        if tr is not None:
            # the span just ended and lasted `seconds`: the trace gets
            # the stage clock's own timing, not a parallel measurement
            tr.add_span(stage, duration_s=seconds)
        with self._lock:
            total, count = self._stages.get(stage, (0.0, 0))
            self._stages[stage] = (total + seconds, count + n)

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
            "frames": frames,
            "frame_e2e_total_s": round(e2e_s, 6),
            "attributed_total_s": round(attributed, 6),
            "coverage": round(attributed / e2e_s, 4) if e2e_s else 0.0,
            "window_s": round(window_s, 3),
        }


#: process-global clock; the bridge, batcher, and instance record here
STAGES = StageStats()
