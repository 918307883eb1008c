"""End-to-end distributed tracing + in-process flight recorder (r16).

The port's copy of gubernator_tpu/serve/tracing.py with its imports
rewritten; the file references below are the reference package's.

The r7 stage clock says where the AVERAGE frame's wall time goes;
Prometheus says how slow the average RPC was. Neither can answer "why
was THIS request slow, and on which hop" — the per-request question
PAPERS.md's scalable-rate-limiting survey names as the operational
prerequisite for running distributed limiters at fleet scale. This
module is that layer:

- **TraceContext**: W3C-trace-context-shaped identity (128-bit trace
  id, 64-bit span id, sampled flag), carried as a `traceparent` header
  string over the HTTP doors, as gRPC metadata on V1/PeersV1 (peer
  forwards, `UpdatePeerGlobals`, `ReplicateBuckets`), and as a binary
  extension on windowed GEB frames (GEBT framing behind the
  HELLO_TRACE capability bit, serve/edge_bridge.py). Fast 33-byte
  records stay trace-free by design — those frames are head-sampled
  bridge-side instead.

- **Trace**: one request's span list, filled from three sources with
  ONE branch per site and no second clock: (a) the existing stage
  clock — `StageStats.add` forwards its span into the active trace
  when one is set (serve/stages.py), so bridge_decode / shed /
  instance_route / encode timings are the same numbers the stage
  profile reports; (b) the device batcher, whose queue marks carry the
  caller's trace so batch_queue and device spans land with batch
  size / ladder rung / algorithm-mix annotations even though the
  flusher runs outside the caller's context; (c) explicit hop spans
  (peer_forward) at the instance tier.

- **Tracer + FlightRecorder**: per-instance (so a LocalCluster's nodes
  keep separate recorders). Head sampling admits a request with
  probability `GUBER_TRACE_SAMPLE` (default 0 = off). Tail capture
  (`GUBER_TRACE_SLOW_MS` > 0) arms span collection for EVERY request
  but only RETAINS completed traces slower than
  max(GUBER_TRACE_SLOW_MS, rolling p99 of recent requests) — the
  "always keep the outliers" half head sampling cannot give. Retained
  traces land in a bounded ring served as JSON at /v1/debug/traces
  (serve/server.py), with counters exported lazily at /metrics scrape.

Cost contract: with sampling AND tail capture off, every hot-path site
pays exactly one `ContextVar.get` / attribute check and no trace ids
are ever generated; ids are generated lazily even for armed traces
(first propagation or retention), so a tail-armed request that
finishes fast allocates a Trace and its span tuples, nothing else.
Pinned by the perf-gate `trace_r16` pair and the tracing differential
fuzz (decisions byte-identical ON vs OFF). Stdlib-only on purpose:
the JAX-free client tier (client_geb.py) imports this module too.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Dict, List, Optional

#: the active request's Trace (or None); set at the door, read by the
#: stage clock, the batcher's enqueue, and the peer client
_CURRENT: "contextvars.ContextVar[Optional[Trace]]" = contextvars.ContextVar(
    "guber_trace", default=None
)

TRACEPARENT = "traceparent"

#: rolling window of recent request durations backing the tail-capture
#: threshold; 512 keeps the p99 meaningful while staying O(KiB)
_WINDOW = 512
#: recompute the rolling p99 every this many finished requests — the
#: hot path never sorts
_P99_EVERY = 64


def _gen_trace_id() -> int:
    return random.getrandbits(128) or 1


def _gen_span_id() -> int:
    return random.getrandbits(64) or 1


class TraceContext:
    """One hop's identity triple, in W3C traceparent shape."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def header(self) -> str:
        return "00-%032x-%016x-%02x" % (
            self.trace_id & ((1 << 128) - 1),
            self.span_id & ((1 << 64) - 1),
            1 if self.sampled else 0,
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TraceContext({self.header()})"


def parse_traceparent(value) -> Optional[TraceContext]:
    """Parse a traceparent header; None on anything malformed (a bad
    header from an untrusted client must degrade to 'untraced', never
    to an error)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 or len(flags) != 2:
        return None
    try:
        trace_id = int(tid, 16)
        span_id = int(sid, 16)
        fl = int(flags, 16)
        int(ver, 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return TraceContext(trace_id, span_id, bool(fl & 1))


class Trace:
    """One request's span collection. Span adds are lock-guarded: the
    device batcher resolves futures from fetch-pool threads while the
    serving loop records door-side stages."""

    __slots__ = (
        "door",
        "sampled",
        "t0",
        "start_unix_ms",
        "_trace_id",
        "_span_id",
        "parent_span_id",
        "_spans",
        "_ann",
        "_lock",
    )

    def __init__(
        self,
        door: str,
        sampled: bool,
        remote: Optional[TraceContext] = None,
    ):
        self.door = door
        self.sampled = sampled
        self.t0 = time.monotonic()
        self.start_unix_ms = int(time.time() * 1000)
        # ids are LAZY: generated on first propagation or retention, so
        # an armed-but-fast-and-unsampled request never pays them
        self._trace_id = remote.trace_id if remote is not None else None
        self._span_id: Optional[int] = None
        self.parent_span_id = (
            remote.span_id if remote is not None else None
        )
        self._spans: List[tuple] = []
        self._ann: Dict[str, object] = {}
        self._lock = threading.Lock()

    @property
    def trace_id(self) -> int:
        if self._trace_id is None:
            self._trace_id = _gen_trace_id()
        return self._trace_id

    @property
    def span_id(self) -> int:
        if self._span_id is None:
            self._span_id = _gen_span_id()
        return self._span_id

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    def header(self) -> Optional[str]:
        """Propagation header — only SAMPLED traces cross process
        boundaries (a tail-armed trace cannot know it will be slow, so
        it stays local; the remote hop has its own tail capture)."""
        if not self.sampled:
            return None
        return self.context().header()

    def add_span(
        self,
        name: str,
        start: Optional[float] = None,
        end: Optional[float] = None,
        duration_s: Optional[float] = None,
        **annotations,
    ) -> None:
        """Record one span. Times are time.monotonic seconds; pass
        either (start[, end]) or duration_s (stage-clock style: the
        span just ended and lasted duration_s)."""
        now = time.monotonic()
        if duration_s is not None:
            end = now if end is None else end
            start = end - max(0.0, duration_s)
        elif start is None:
            start = now
        if end is None:
            end = now
        with self._lock:
            self._spans.append(
                (name, start, end, annotations or None)
            )

    def annotate(self, **kv) -> None:
        with self._lock:
            self._ann.update(kv)

    def freeze(self, duration_s: float, tail: bool) -> dict:
        """Serialize for the recorder (called once, at retention).
        Span times become millisecond offsets from the trace start."""
        with self._lock:
            spans = [
                {
                    "name": name,
                    "start_ms": round((s - self.t0) * 1e3, 3),
                    "duration_ms": round((e - s) * 1e3, 3),
                    **({"annotations": ann} if ann else {}),
                }
                for name, s, e, ann in self._spans
            ]
            ann = dict(self._ann)
        doc = {
            "trace_id": "%032x" % self.trace_id,
            "span_id": "%016x" % self.span_id,
            "door": self.door,
            "sampled": self.sampled,
            "tail": tail,
            "start_unix_ms": self.start_unix_ms,
            "duration_ms": round(duration_s * 1e3, 3),
            "spans": spans,
        }
        if self.parent_span_id is not None:
            doc["parent_span_id"] = "%016x" % self.parent_span_id
        if ann:
            doc["annotations"] = ann
        return doc


class FlightRecorder:
    """Bounded in-process ring of completed traces + plain-int counters
    (exported lazily at /metrics scrape, the shed_entries pattern)."""

    def __init__(self, capacity: int = 256, slow_ms: float = 0.0):
        self.capacity = max(1, int(capacity))
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._traces: List[dict] = []
        # counters: plain ints under the lock — the hot path (record)
        # already holds it, the scrape reads without caring about a
        # torn read of a monotonic int
        self.started = 0  # traces begun (sampled or tail-armed)
        self.sampled = 0  # head-sampled at a door
        self.recorded = 0  # retained in the ring
        self.tail_captured = 0  # retained by the slow-threshold rule
        self.dropped = 0  # evicted from the ring (capacity)
        # rolling duration window for the p99 threshold
        self._durs: List[float] = []
        self._dur_i = 0
        self._since_p99 = 0
        self._p99_ms = 0.0

    def threshold_ms(self) -> float:
        """Tail-capture retention threshold: the knob is the FLOOR, the
        rolling p99 lifts it under load so the recorder keeps outliers
        relative to current behavior, not a stale absolute."""
        return max(self.slow_ms, self._p99_ms)

    def observe(self, trace: Trace, duration_s: float) -> None:
        """One finished trace: decide retention, update the rolling
        window."""
        dur_ms = duration_s * 1e3
        tail = False
        with self._lock:
            if self.slow_ms > 0:
                if len(self._durs) < _WINDOW:
                    self._durs.append(dur_ms)
                else:
                    self._durs[self._dur_i] = dur_ms
                    self._dur_i = (self._dur_i + 1) % _WINDOW
                self._since_p99 += 1
                if self._since_p99 >= _P99_EVERY:
                    self._since_p99 = 0
                    s = sorted(self._durs)
                    self._p99_ms = s[max(0, int(len(s) * 0.99) - 1)]
                tail = not trace.sampled and dur_ms >= self.threshold_ms()
            if not (trace.sampled or tail):
                return
        # freeze outside the recorder lock (it takes the trace's own)
        doc = trace.freeze(duration_s, tail)
        with self._lock:
            self.recorded += 1
            if tail:
                self.tail_captured += 1
            self._traces.append(doc)
            if len(self._traces) > self.capacity:
                del self._traces[0]
                self.dropped += 1

    def get(self, trace_id_hex: str) -> Optional[dict]:
        tid = trace_id_hex.lower().lstrip("0") or "0"
        with self._lock:
            for doc in reversed(self._traces):
                if doc["trace_id"].lstrip("0") == tid:
                    return doc
        return None

    def snapshot(self, limit: int = 64) -> dict:
        with self._lock:
            # limit<=0 means "counters only": [-0:] would slice the
            # WHOLE ring, so branch explicitly
            traces = list(self._traces[-limit:]) if limit > 0 else []
            return {
                "traces": traces,
                "count": len(self._traces),
                "capacity": self.capacity,
                "slow_threshold_ms": round(self.threshold_ms(), 3),
                "counters": self.counters(),
            }

    def counters(self) -> dict:
        return {
            "started": self.started,
            "sampled": self.sampled,
            "recorded": self.recorded,
            "tail_captured": self.tail_captured,
            "dropped": self.dropped,
        }

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self.started = self.sampled = self.recorded = 0
            self.tail_captured = self.dropped = 0
            self._durs = []
            self._dur_i = self._since_p99 = 0
            self._p99_ms = 0.0


class Tracer:
    """Per-instance sampling policy + recorder. `sample` and `slow_ms`
    are plain attributes so the perf gate (and an operator with a
    debugger) can flip them on a live process."""

    def __init__(
        self,
        sample: float = 0.0,
        slow_ms: float = 0.0,
        capacity: int = 256,
    ):
        self.sample = float(sample)
        self.slow_ms = float(slow_ms)
        self.recorder = FlightRecorder(capacity, slow_ms=slow_ms)

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0 or self.slow_ms > 0.0

    def begin(self, door: str) -> Optional[Trace]:
        """Door entry with no incoming context: head-sample, else arm
        for tail capture, else None (the disabled fast path — one
        float compare, no allocation)."""
        if self.sample > 0.0 and random.random() < self.sample:
            tr = Trace(door, sampled=True)
            rec = self.recorder
            rec.started += 1
            rec.sampled += 1
            return tr
        if self.slow_ms > 0.0:
            # slow_ms may have been flipped at runtime; keep the
            # recorder's threshold floor in step
            rec = self.recorder
            rec.slow_ms = self.slow_ms
            rec.started += 1
            return Trace(door, sampled=False)
        return None

    def join(
        self, door: str, ctx: Optional[TraceContext]
    ) -> Optional[Trace]:
        """Door entry with a (possibly absent) incoming context. A
        remote SAMPLED context is honored whenever this node has
        tracing enabled AT ALL (any sample rate or tail capture) — the
        origin made the sampling decision for the whole request, and
        re-rolling the dice here would sever the cross-node trace. A
        node with tracing fully OFF ignores carried contexts too:
        traceparent arrives on UNTRUSTED doors (client HTTP/gRPC, the
        GEB port), and a client-supplied header must not be able to
        force span collection + recorder churn past the operator's
        GUBER_TRACE_*=0 policy. Anything else falls back to this
        node's own head/tail policy."""
        if ctx is not None and ctx.sampled and self.enabled:
            tr = Trace(door, sampled=True, remote=ctx)
            self.recorder.started += 1
            return tr
        return self.begin(door)

    def finish(self, trace: Optional[Trace]) -> None:
        if trace is None:
            return
        self.recorder.observe(trace, time.monotonic() - trace.t0)


# -- context plumbing --------------------------------------------------------


def active() -> Optional[Trace]:
    """The caller's active trace, or None — THE one-branch probe every
    instrumented site uses."""
    return _CURRENT.get()


def activate(trace: Trace):
    return _CURRENT.set(trace)


def deactivate(token) -> None:
    _CURRENT.reset(token)


def propagation_header() -> Optional[str]:
    """traceparent for an outbound hop from the current context, or
    None (unsampled / untraced — nothing crosses the wire)."""
    tr = _CURRENT.get()
    if tr is None:
        return None
    return tr.header()


class scope:
    """`with tracing.scope(tracer, trace):` — activate for the body,
    then finish into the recorder. A None trace is a no-op, so door
    code stays branch-free."""

    __slots__ = ("tracer", "trace", "_token")

    def __init__(self, tracer: Optional[Tracer], trace: Optional[Trace]):
        self.tracer = tracer
        self.trace = trace
        self._token = None

    def __enter__(self) -> Optional[Trace]:
        if self.trace is not None:
            self._token = _CURRENT.set(self.trace)
        return self.trace

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
        if self.trace is not None and self.tracer is not None:
            self.tracer.finish(self.trace)
        return False
