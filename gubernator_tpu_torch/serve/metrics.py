"""Prometheus metrics, name-compatible with the reference's collectors.

The port's copy of gubernator_tpu/serve/metrics.py with its imports
rewritten, with every series of the reference's (bucket replication,
ring rescale and checkpoint/restore included: same names, labels and
help texts). The file references below are the reference package's.

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
EDGE_FAST_ITEMS = Counter(
    "edge_fast_items_total",
    "Rate-limit items served through the pre-hashed (GEB6) edge fast "
    "path on this node — in a cluster, nonzero on every node proves the "
    "edge ships per-owner frames instead of funnelling through one node",
    registry=REGISTRY,
)
EDGE_FOLDED_ITEMS = Counter(
    "edge_folded_items_total",
    "String-frame items served through the bridge's string->array fold "
    "(all-plain all-owned frames skip request/response objects and "
    "instance routing) — the slow path's share of fast-path treatment",
    registry=REGISTRY,
)
EDGE_STALE_RINGS = Counter(
    "edge_stale_ring_total",
    "GEB6 frames rejected because the edge routed with a different "
    "membership view than this node (the edge refreshes and retries)",
    registry=REGISTRY,
)
GEB_SHM_SESSIONS = Counter(
    "geb_shm_sessions_total",
    "Shared-memory GEB lanes negotiated on this node's bridge (r18, "
    "serve/shm.py GEBM/GEBN over the unix control socket); compare "
    "with geb_shm_teardowns_total to see lanes torn down early",
    registry=REGISTRY,
)
GEB_SHM_FRAMES = Counter(
    "geb_shm_frames_total",
    "Request frames served through shared-memory rings instead of a "
    "socket (r18) — the co-located fast lane's share of bridge traffic",
    registry=REGISTRY,
)
GEB_SHM_TEARDOWNS = Counter(
    "geb_shm_teardowns_total",
    "Shared-memory lanes torn down for cause (hostile/torn ring "
    "state, a client that stopped draining, serve failures) rather "
    "than a clean close — nonzero under normal operation means a "
    "misbehaving co-located peer",
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
REPLICATION_SNAPSHOTS_SENT = Counter(
    "replication_snapshots_sent_total",
    "Owned-bucket snapshots shipped to ring successors (and reconcile "
    "handbacks to returned owners) over ReplicateBuckets "
    "(GUBER_REPLICATION=1, serve/replication.py)",
    registry=REGISTRY,
)
REPLICATION_STANDBY_ENTRIES = Gauge(
    "replication_standby_entries",
    "Live snapshots in the receiver-side standby table (bounded by "
    "GUBER_REPLICATION_STANDBY_KEYS; consulted only on takeover)",
    registry=REGISTRY,
)
REPLICATED_TAKEOVERS = Counter(
    "replicated_takeovers_total",
    "First-touch decisions seeded from a standby snapshot after a "
    "takeover (owner dead or removed) instead of starting a fresh "
    'window; the seeded responses carry metadata["replicated"]="true"',
    registry=REGISTRY,
)
REPLICATION_RECONCILES = Counter(
    "replication_reconciles_total",
    "Snapshots installed directly into the LOCAL store because this "
    "node owns their keys (reconcile handback from the interim "
    "successor after an owner returns)",
    registry=REGISTRY,
)
REPLICATION_LAG = Gauge(
    "replication_lag_seconds",
    "Age of the last snapshot applied at takeover/reconcile time "
    "(receiver clock minus the owner's snapshot_ms stamp; bounded by "
    "one GUBER_REPLICATION_SYNC_WAIT_MS window + RTT when healthy)",
    registry=REGISTRY,
)
REPLICATION_DROPPED = Counter(
    "replication_dropped_total",
    "Replication entries dropped at a bound: dirty-backlog keys past "
    "GUBER_REPLICATION_BACKLOG, standby evictions past "
    "GUBER_REPLICATION_STANDBY_KEYS",
    ["what"],
    registry=REGISTRY,
)
RESCALE_KEYS_MOVED = Counter(
    "rescale_keys_moved_total",
    "Live token windows handed to their NEW ring owner on a membership "
    "change, a planned drain, or a double-serve reconcile tick "
    "(GUBER_RESCALE=1, serve/rescale.py; delivered over "
    "ReplicateBuckets with last-write-wins installs, so retries and "
    "duplicates re-count here but no-op on the receiver)",
    registry=REGISTRY,
)
RESCALE_HANDOFF_LAG = Gauge(
    "rescale_handoff_lag_seconds",
    "Sender side: wall time from a ring change to its moved windows "
    "being delivered to their new owners (target: under two "
    "GUBER_REPLICATION_SYNC_WAIT_MS flush windows). Receivers "
    "re-stamp it with the age of the snapshots they install",
    registry=REGISTRY,
)
RESCALE_DOUBLE_SERVE = Counter(
    "rescale_double_serve_answers_total",
    "Peer-forwarded requests this node answered for keys it no longer "
    "owns, inside an open GUBER_RESCALE_DOUBLE_SERVE_MS window after a "
    "ring change (the old owner's warm store answers while the new "
    "owner installs; the end-of-window flush reconciles, LWW)",
    registry=REGISTRY,
)
RESCALE_DROPPED = Counter(
    "rescale_dropped_total",
    "Rescale entries dropped at a bound: tracked owned keys evicted "
    "past GUBER_RESCALE_TRACK_KEYS (freshest kept), pending handoff "
    "snapshots evicted past the same bound on the receiver",
    ["what"],
    registry=REGISTRY,
)
RESCALE_TRACKED_ENTRIES = Gauge(
    "rescale_tracked_entries",
    "Owned token windows tracked for planned handoff + pending "
    "received snapshots awaiting this node's ring flip (bounded by "
    "GUBER_RESCALE_TRACK_KEYS each; set lazily at /metrics scrape)",
    registry=REGISTRY,
)
CHECKPOINT_AGE = Gauge(
    "checkpoint_age_seconds",
    "Age of the newest durable checkpoint on disk (now minus the last "
    "successful flush's snapshot stamp; set lazily at /metrics scrape). "
    "Grows without bound while writes fail or hang — alert when it "
    "passes GUBER_CHECKPOINT_MAX_AGE_MS, because a restart past that "
    "bound boots cold by design",
    registry=REGISTRY,
)
RESTORE_LAG = Gauge(
    "restore_lag_seconds",
    "Staleness of the state this process restored at boot (restore "
    "wall clock minus the checkpoint's owner-clock snapshot stamp, or "
    "the import batch's stamp for a blue-green bulk load). Bounded by "
    "GUBER_CHECKPOINT_MAX_AGE_MS for disk restores — stale checkpoints "
    "are refused and the node boots cold instead",
    registry=REGISTRY,
)
RESTORED_WINDOWS = Counter(
    "restored_windows_total",
    "Bucket windows installed from durable state: boot-time warm "
    "restore from GUBER_CHECKPOINT_DIR plus blue-green import installs "
    "received over ReplicateBuckets (LWW, so double-delivery counts "
    "once per accepted install, never double-admits)",
    registry=REGISTRY,
)
CHECKPOINT_FAILURES = Counter(
    "checkpoint_failures_total",
    "Checkpoint subsystem failures by kind: 'write' (a flush could not "
    "land its chunks/manifest), 'read' (unreadable file at restore), "
    "'corrupt' (CRC/parse mismatch — torn or truncated file), 'stale' "
    "(manifest older than GUBER_CHECKPOINT_MAX_AGE_MS), 'version' (a "
    "FUTURE format version refused), 'export' (a blue-green export "
    "send failed). Every kind boots/continues cold and loudly — never "
    "a crash, never a wedge",
    ["what"],
    registry=REGISTRY,
)
CHECKPOINT_TRACKED_ENTRIES = Gauge(
    "checkpoint_tracked_entries",
    "Owned token windows tracked for the next checkpoint flush + "
    "pending import snapshots awaiting re-route to their ring owner "
    "(bounded by GUBER_CHECKPOINT_TRACK_KEYS each; set lazily at "
    "/metrics scrape)",
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
FRAME_INFLIGHT = Gauge(
    "frame_inflight",
    "GEB frames accepted but not yet answered on this door (bounded "
    "by credit window x connections); door = edge (bridge socket/TCP) "
    "| geb (GUBER_GEB_PORT client door)",
    ["door"],
    registry=REGISTRY,
)
FRAME_CONNECTIONS = Gauge(
    "frame_connections",
    "Live connections on a GEB frame door (same door label set as "
    "frame_inflight)",
    ["door"],
    registry=REGISTRY,
)
REPLICATION_BACKLOG_ENTRIES = Gauge(
    "replication_backlog_entries",
    "Dirty owned keys + takeover-tracked keys awaiting the next "
    "replication flush (bounded by GUBER_REPLICATION_BACKLOG)",
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
