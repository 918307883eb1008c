"""Prometheus metrics, name-compatible with the reference's collectors.

The port's copy of gubernator_tpu/serve/metrics.py with its imports
rewritten, less the metrics of what the port does not carry yet (the
edge bridge and GEB door with its shm lane and frame gauges, bucket
replication, ring rescale, checkpoint/restore): a counter that can only
read 0 would tell an operator the feature is on. The file references
below are the reference package's.

- grpc_request_counts{status,method} and
  grpc_request_duration_milliseconds{method} (reference prometheus.go:50-63)
- cache_size, cache_access_count{type} (reference cache/lru.go:56-59,164-176)
- async_durations / broadcast_durations GLOBAL histograms
  (reference global.go:44-51)
- plus TPU-specific gauges: device batch sizes and kernel launch latency.
"""

from __future__ import annotations

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

REGISTRY = CollectorRegistry()

GRPC_REQUEST_COUNTS = Counter(
    "grpc_request_counts",
    "The count of gRPC requests",
    ["status", "method"],
    registry=REGISTRY,
)
GRPC_REQUEST_DURATION = Histogram(
    "grpc_request_duration_milliseconds",
    "The duration of gRPC requests in milliseconds",
    ["method"],
    buckets=(0.1, 0.5, 1, 2, 5, 10, 25, 50, 100, 500, 1000),
    registry=REGISTRY,
)
CACHE_SIZE = Gauge(
    "cache_size",
    "The number of rate-limit entries in the store",
    registry=REGISTRY,
)
CACHE_ACCESS_COUNT = Counter(
    "cache_access_count",
    "Store access counts",
    ["type"],  # hit | miss
    registry=REGISTRY,
)
GLOBAL_ASYNC_DURATIONS = Histogram(
    "async_durations",
    "The duration of GLOBAL async sends in seconds",
    registry=REGISTRY,
)
GLOBAL_BROADCAST_DURATIONS = Histogram(
    "broadcast_durations",
    "The duration of GLOBAL broadcasts to peers in seconds",
    registry=REGISTRY,
)
DEVICE_BATCH_SIZE = Histogram(
    "device_batch_size",
    "Requests coalesced per device kernel launch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
    registry=REGISTRY,
)
DEVICE_LAUNCH_MS = Histogram(
    "device_launch_milliseconds",
    "Wall time of one decide kernel launch (host-observed)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 25, 100),
    registry=REGISTRY,
)
STORE_DROPPED_CREATES = Counter(
    "store_dropped_creates_total",
    "Creates lost to bucket way exhaustion (over-admission signal: the "
    "dropped key is re-admitted fresh on its next batch)",
    registry=REGISTRY,
)
STORE_EVICTIONS = Counter(
    "store_evictions_total",
    "Store entries overwritten by the earliest-expiry eviction policy "
    "(over-admission signal at capacity; reference cache/lru.go:164-176 "
    "exposes the analogous cache_size-vs-max pressure)",
    registry=REGISTRY,
)
DISTINCT_KEYS = Gauge(
    "distinct_keys_estimate",
    "HyperLogLog estimate of distinct rate-limit keys seen",
    registry=REGISTRY,
)
STAGE_SECONDS = Gauge(
    "serving_stage_seconds_total",
    "Cumulative wall seconds attributed to one serving-pipeline stage "
    "(serve/stages.py; exported lazily at scrape — the hot path "
    "records into a plain accumulator). Pair with "
    "serving_stage_samples_total for per-sample means.",
    ["stage"],
    registry=REGISTRY,
)
STAGE_SAMPLES = Gauge(
    "serving_stage_samples_total",
    "Samples accumulated per serving-pipeline stage",
    ["stage"],
    registry=REGISTRY,
)
SHED_HITS = Gauge(
    "shed_hits_total",
    "Requests answered from the host over-limit shed cache instead of "
    "the device (serve/shedcache.py; exported lazily at scrape like the "
    "stage totals — the hot path only bumps a plain int)",
    registry=REGISTRY,
)
SHED_LOOKUPS = Gauge(
    "shed_lookups_total",
    "Shed-cache consults for gate-eligible requests (token bucket, "
    "hits > 0); shed hit rate = shed_hits_total / shed_lookups_total",
    registry=REGISTRY,
)
SHED_ENTRIES = Gauge(
    "shed_entries",
    "Live over-limit verdicts in the host shed cache (bounded by "
    "GUBER_SHED_CACHE_KEYS)",
    registry=REGISTRY,
)
FAULTS_INJECTED = Counter(
    "faults_injected_total",
    "Injected faults fired (serve/faults.py, GUBER_FAULT_SPEC) — a "
    "chaos run asserts this is nonzero so it can't pass with its "
    "faults silently misconfigured",
    ["point", "action"],
    registry=REGISTRY,
)
PEER_RPC_RETRIES = Counter(
    "peer_rpc_retries_total",
    "Peer RPC attempts retried after a retryable failure (bounded by "
    "GUBER_PEER_RETRIES, exponential backoff + full jitter)",
    ["peer"],
    registry=REGISTRY,
)
PEER_BREAKER_STATE = Gauge(
    "peer_breaker_state",
    "Per-peer circuit breaker state: 0=closed, 1=half-open, 2=open "
    "(serve/breaker.py; also surfaced through HealthCheck)",
    ["peer"],
    registry=REGISTRY,
)
PEER_BREAKER_TRANSITIONS = Counter(
    "peer_breaker_transitions_total",
    "Circuit breaker state transitions, labelled by destination state",
    ["peer", "to"],
    registry=REGISTRY,
)
DEGRADED_RESPONSES = Counter(
    "degraded_responses_total",
    "Requests answered from the LOCAL store because the owning peer was "
    "unreachable (GUBER_DEGRADED_LOCAL=1; responses carry "
    'metadata["degraded"]="true")',
    registry=REGISTRY,
)
GLOBAL_TASK_RESTARTS = Counter(
    "global_task_restarts_total",
    "GlobalManager background loops restarted after an unexpected death "
    "(supervised with backoff; pre-r8 a dead loop only logged and GLOBAL "
    "gossip silently stopped)",
    ["task"],
    registry=REGISTRY,
)
GLOBAL_FLUSH_BYTES = Counter(
    "global_flush_bytes_total",
    "Approximate payload bytes flushed by the GLOBAL hits loop, "
    "labelled by delivery path: 'rpc' for per-peer gossip sends to "
    "off-mesh ring peers, 'mesh' for self-destined hits applied in one "
    "in-mesh psum collective (r20 mesh-native GLOBAL) — the byte split "
    "shows how much gossip the collective path absorbed",
    ["path"],
    registry=REGISTRY,
)
GLOBAL_BACKLOG_DROPPED = Counter(
    "global_backlog_dropped_total",
    "GLOBAL gossip entries dropped because the aggregation backlog hit "
    "GUBER_GLOBAL_BACKLOG distinct keys (an unreachable owner no longer "
    "grows the hit backlog without bound); labelled by queue (hits | "
    "updates)",
    ["queue"],
    registry=REGISTRY,
)
SKETCH_PROMOTIONS = Counter(
    "sketch_promotions_total",
    "Hot sketch-tier keys migrated into exact-tier buckets by the "
    "streaming promoter (GUBER_SKETCH=1, serve/promoter.py): the "
    "window continues from the count-min estimate instead of the tail "
    "tier's approximate math",
    registry=REGISTRY,
)
SKETCH_DEMOTIONS = Counter(
    "sketch_demotions_total",
    "Promoted keys released by the promoter (their installed window "
    "expired, or their count decayed out of the top-K candidate set); "
    "the key falls back to the sketch tier on its next window",
    registry=REGISTRY,
)
SKETCH_SHED_SEEDS = Counter(
    "sketch_shed_seeds_total",
    "Over-limit hot candidates the promoter seeded straight into the "
    "r10 shed cache (estimate >= limit at promotion time): their "
    "refusals answer host-side without a device trip",
    registry=REGISTRY,
)
DRAIN_DURATION = Gauge(
    "drain_duration_seconds",
    "Wall time of the last graceful drain (SIGTERM: deregister, refuse "
    "new edge frames, flush batcher + GLOBAL queues; bounded by "
    "GUBER_DRAIN_TIMEOUT_MS)",
    registry=REGISTRY,
)
# -- queue-visibility gauges (r16): occupancy the stage clock cannot
# express (it times spans, not standing depth). All set lazily at
# /metrics scrape like shed_entries — the hot paths keep plain
# counters/queues and pay nothing.
BATCHER_QUEUE_DEPTH = Gauge(
    "batcher_queue_depth",
    "Caller groups standing in the device batcher (queued + collected "
    "+ parked carry) at scrape time",
    registry=REGISTRY,
)
BATCHER_QUEUE_AGE = Gauge(
    "batcher_queue_oldest_age_seconds",
    "Age of the oldest caller group standing in the device batcher — "
    "a growing value with flat depth means the flusher is wedged, not "
    "merely busy",
    registry=REGISTRY,
)
PREP_BACKLOG = Gauge(
    "prep_pool_backlog",
    "Arrival-prep tasks queued behind the prep pool's workers "
    "(GUBER_PREP_THREADS); sustained backlog means prep no longer "
    "hides inside the batcher queue wait (serve/batcher.py, r9)",
    registry=REGISTRY,
)
GLOBAL_BACKLOG_ENTRIES = Gauge(
    "global_backlog_entries",
    "Distinct keys standing in a GLOBAL aggregation queue (bounded by "
    "GUBER_GLOBAL_BACKLOG); queue = hits (non-owner forwards) | "
    "updates (owner broadcasts)",
    ["queue"],
    registry=REGISTRY,
)
# -- distributed tracing (r16, serve/tracing.py): recorder counters,
# exported lazily at scrape from the per-instance flight recorder
TRACES_STARTED = Gauge(
    "traces_started_total",
    "Requests that began span collection (head-sampled via "
    "GUBER_TRACE_SAMPLE, joined from a remote sampled context, or "
    "armed for tail capture via GUBER_TRACE_SLOW_MS)",
    registry=REGISTRY,
)
TRACES_RECORDED = Gauge(
    "traces_recorded_total",
    "Completed traces retained in the flight recorder "
    "(/v1/debug/traces)",
    registry=REGISTRY,
)
TRACES_TAIL_CAPTURED = Gauge(
    "traces_tail_captured_total",
    "Traces retained by the tail rule alone: unsampled requests "
    "slower than max(GUBER_TRACE_SLOW_MS, rolling p99)",
    registry=REGISTRY,
)
TRACES_DROPPED = Gauge(
    "traces_dropped_total",
    "Retained traces evicted from the flight-recorder ring "
    "(GUBER_TRACE_BUFFER bound)",
    registry=REGISTRY,
)
TRACE_SLOW_THRESHOLD = Gauge(
    "trace_slow_threshold_ms",
    "Current tail-capture retention threshold: max of the "
    "GUBER_TRACE_SLOW_MS floor and the rolling p99 of recent request "
    "durations",
    registry=REGISTRY,
)


def render() -> bytes:
    """Text exposition for the /metrics endpoint."""
    return generate_latest(REGISTRY)
