"""Server daemon: gRPC V1 + PeersV1 services, HTTP JSON gateway, /metrics
(the port of gubernator_tpu/serve/server.py).

Wires config -> backend -> Instance -> servers, mirroring the reference
daemon's shape (reference cmd/gubernator/main.go:40-147): gRPC on one
listener, an HTTP gateway exposing POST /v1/GetRateLimits and
GET /v1/HealthCheck as JSON plus GET /metrics for Prometheus, discovery
(etcd, else Kubernetes Endpoints, else the static peer list; see
serve/discovery.py) pushing the peer list into Instance.set_peers, and
graceful shutdown. The GEB frame doors (serve/edge_bridge.py) ride
beside them: the client-facing GEB door (GUBER_GEB_PORT), POST /v1/geb
on the HTTP port, and the edge bridge (GUBER_EDGE_SOCKET,
GUBER_EDGE_TCP) with its shared-memory lane. The backend is the port's own
(serve/backends.make_backend) on `device`: cuda unless the caller asks
for another.

The durability managers ride the Instance (serve/replication.py,
serve/rescale.py, serve/checkpoint.py): PeersV1.ReplicateBuckets feeds
their receive path, a checkpoint restore runs at boot right after the
Instance starts and before any door opens, and the drain runs their
rescale handoff, replication flush and final checkpoint.

On a multi-host mesh (GUBER_DIST_COORDINATOR) this server is process 0's
role over GUBER_BACKEND=multihost; cli/daemon.py joins the process group
first and runs every other process as a lockstep follower. `stop()`
closes the backend, which shuts the step pipe and so releases the
followers.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile
import time
from typing import Optional

import grpc
from aiohttp import web

from gubernator_tpu_torch.api import convert
from gubernator_tpu_torch.api.grpc_glue import add_peers_servicer, add_v1_servicer
from gubernator_tpu_torch.api.proto.gen import gubernator_pb2, peers_pb2
from gubernator_tpu_torch.core.hashing import using_native_hash
from gubernator_tpu_torch.core.store import DeviceLike
from gubernator_tpu_torch.native import load_hashlib
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.backends import make_backend
from gubernator_tpu_torch.serve.config import ServerConfig
from gubernator_tpu_torch.serve.instance import BatchTooLargeError, Instance
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.server")


class _Timed:
    """Method timing -> grpc_request_counts / duration histograms
    (the stats-handler role, reference prometheus.go:104-127)."""

    def __init__(self, method: str):
        self.method = method

    def __enter__(self):
        self.start = time.monotonic()
        return self

    def __exit__(self, exc_type, *_):
        ms = (time.monotonic() - self.start) * 1000.0
        metrics.GRPC_REQUEST_DURATION.labels(self.method).observe(ms)
        metrics.GRPC_REQUEST_COUNTS.labels(
            "failed" if exc_type else "success", self.method
        ).inc()
        return False


class StatsInterceptor(grpc.aio.ServerInterceptor):
    """Times EVERY unary RPC generically by method name — the
    stats-handler contract of the reference (prometheus.go:104-127): a
    method added tomorrow is metered automatically."""

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None or handler.unary_unary is None:
            return handler  # only unary-unary RPCs exist in this API
        method = handler_call_details.method
        inner = handler.unary_unary

        async def timed(request, context):
            with _Timed(method):
                return await inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            timed,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )


def _md_traceparent(context) -> "Optional[str]":
    """The traceparent entry of an RPC's invocation metadata, or None."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == tracing.TRACEPARENT:
                return v
    except Exception:  # pragma: no cover - defensive
        pass
    return None


class V1Servicer:
    def __init__(self, instance: Instance):
        self.instance = instance

    async def GetRateLimits(self, request, context):
        reqs = [convert.req_from_pb(p) for p in request.requests]
        tracer = self.instance.tracer
        trace = tracer.join(
            "grpc", tracing.parse_traceparent(_md_traceparent(context))
        )
        try:
            with tracing.scope(tracer, trace) as tr:
                if tr is not None:
                    tr.annotate(items=len(reqs))
                resps = await self.instance.get_rate_limits(reqs)
        except BatchTooLargeError as e:
            await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        return gubernator_pb2.GetRateLimitsResp(
            responses=[convert.resp_to_pb(r) for r in resps]
        )

    async def HealthCheck(self, request, context):
        h = self.instance.health_check()
        return gubernator_pb2.HealthCheckResp(
            status=h.status, message=h.message, peer_count=h.peer_count
        )


class PeersV1Servicer:
    def __init__(self, instance: Instance):
        self.instance = instance

    async def GetPeerRateLimits(self, request, context):
        reqs = [convert.req_from_pb(p) for p in request.requests]
        # owner-serve hop of a distributed trace (r16): a forwarding
        # peer's sampled context arrives as gRPC metadata; the owner
        # records its own queue/device spans under the SAME trace id
        tracer = self.instance.tracer
        trace = tracer.join(
            "peers", tracing.parse_traceparent(_md_traceparent(context))
        )
        try:
            with tracing.scope(tracer, trace) as tr:
                if tr is not None:
                    tr.annotate(items=len(reqs))
                resps = await self.instance.get_peer_rate_limits(reqs)
        except BatchTooLargeError as e:
            await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        return peers_pb2.GetPeerRateLimitsResp(
            rate_limits=[convert.resp_to_pb(r) for r in resps]
        )

    async def UpdatePeerGlobals(self, request, context):
        updates = [
            (g.key, convert.resp_from_pb(g.status)) for g in request.globals
        ]
        # background gossip sends bare metadata; only an install that
        # originated inside a traced request carries context here
        tracer = self.instance.tracer
        tp = _md_traceparent(context)
        trace = (
            tracer.join("peers_update", tracing.parse_traceparent(tp))
            if tp
            else None
        )
        with tracing.scope(tracer, trace):
            await self.instance.update_peer_globals(updates)
        return peers_pb2.UpdatePeerGlobalsResp()

    async def ReplicateBuckets(self, request, context):
        from gubernator_tpu_torch.serve.replication import Snapshot

        snaps = [
            Snapshot(
                key=b.key,
                algorithm=b.algorithm,
                limit=b.limit,
                duration=b.duration,
                remaining=b.remaining,
                reset_time=b.reset_time,
                status=b.status,
                snapshot_ms=b.snapshot_ms,
            )
            for b in request.buckets
        ]
        tracer = self.instance.tracer
        tp = _md_traceparent(context)
        trace = (
            tracer.join("peers_replicate", tracing.parse_traceparent(tp))
            if tp
            else None
        )
        with tracing.scope(tracer, trace):
            await self.instance.replicate_buckets(request.owner, snaps)
        return peers_pb2.ReplicateBucketsResp()


def register_servicers(grpc_server, instance: Instance):
    """Embed gubernator in a caller-owned `grpc.aio` server (reference
    config.go:29-30, architecture.md:79-91): register the V1 + PeersV1
    services on `grpc_server` and return the instance. The caller owns
    the server lifecycle and membership:

        backend = make_backend(conf)          # cuda unless device= says
        instance = Instance(conf, backend)
        instance.start()                      # batcher + gossip tasks
        register_servicers(my_grpc_server, instance)
        await my_grpc_server.start()
        await instance.set_peers([PeerInfo(address=..., is_owner=...)])
        ...
        await instance.stop()                 # before the loop closes

    Call inside the event loop that will run the server: Instance.start()
    binds its batcher to the running loop. set_peers replaces the full
    membership each call (pass every live peer, with is_owner=True on
    this node's own advertise address); backend.warmup() is the
    caller's pre-serve step, as in Server._start_inner."""
    add_v1_servicer(grpc_server, V1Servicer(instance))
    add_peers_servicer(grpc_server, PeersV1Servicer(instance))
    return instance


#: where /v1/debug/profile writes its traces (under TMPDIR)
PROFILE_DIR = os.path.join(tempfile.gettempdir(), "guber-profile")

#: content type of the HTTP binary door (POST /v1/geb); a deliberate
#: mirror of client_geb.GEB_CONTENT_TYPE (the client loads no server code)
GEB_CONTENT_TYPE = "application/x-guber-geb"


class Server:
    """One daemon: gRPC + HTTP, an Instance, and discovery."""

    _profiling = False
    _edge = None
    _geb = None
    _geb_core = None

    def __init__(
        self, conf: ServerConfig, backend=None, device: DeviceLike = None
    ):
        self.conf = conf
        self.backend = (
            backend if backend is not None else make_backend(conf, device=device)
        )
        self.instance = Instance(conf, self.backend)
        self.grpc_server: Optional[grpc.aio.Server] = None
        self._http_runner: Optional[web.AppRunner] = None
        self._pool = None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        try:
            await self._start_inner()
        except Exception:
            # a partial start (bind failure, bad static peer, ...) must
            # not leak the instance's already-running tasks
            await self.stop()
            raise

    async def _start_inner(self) -> None:
        warmup = getattr(self.backend, "warmup", None)
        if warmup is not None:
            # run every device-batch rung once (the kernel's build and
            # load included) before accepting traffic
            await asyncio.to_thread(warmup)
        self.instance.start()
        if self.instance.checkpoint is not None:
            # boot-time warm restore BEFORE any door opens: the batcher
            # runs (the installs need it) but no traffic can race the
            # install. Every failure path inside boots cold and loudly
            await self.instance.checkpoint.restore()

        self.grpc_server = grpc.aio.server(
            interceptors=[StatsInterceptor()],
            options=[("grpc.max_receive_message_length", 1 << 20)],
        )
        register_servicers(self.grpc_server, self.instance)
        bound = self.grpc_server.add_insecure_port(self.conf.grpc_address)
        if bound == 0:
            raise RuntimeError(
                f"failed to bind gRPC address {self.conf.grpc_address}"
            )
        await self.grpc_server.start()
        log.info("gRPC listening on %s", self.conf.grpc_address)
        batcher = self.instance.batcher
        hn = load_hashlib()
        if hn is not None:
            log.info(
                "native prep: %d thread(s) (GUBER_PREP_THREADS), slot hash %s",
                hn.prep_threads(),
                "XXH64" if using_native_hash() else "blake2b-8",
            )
        else:
            log.info(
                "native prep library not built/loadable; numpy fallbacks "
                "active, slot hash blake2b-8"
            )
        log.info(
            "arrival prep %s (GUBER_PREP_AT_ARRIVAL), %d prep thread(s) "
            "(GUBER_PREP_THREADS), fetch depth %d (GUBER_FETCH_DEPTH)",
            "on" if batcher.prep_at_arrival else "off",
            batcher.prep_threads, batcher.fetch_depth,
        )

        shed = self.instance.shed
        if shed is not None:
            # boot-time sizing lint, like the store footprint pass in
            # make_backend: an over-provisioned shed bound is host
            # memory that can never hold a live verdict
            from gubernator_tpu_torch.serve.shedcache import (
                footprint_mib,
                lint_footprint,
            )

            eng = getattr(self.backend, "engine", None)
            cap = eng.config.rows * eng.config.slots if eng is not None else 0
            lint = lint_footprint(shed.capacity, cap)
            if lint:
                log.warning("%s", lint)
            log.info(
                "over-limit shed cache: %d keys (~%.1f MiB) "
                "(GUBER_SHED_CACHE / GUBER_SHED_CACHE_KEYS)",
                shed.capacity, footprint_mib(shed.capacity),
            )
        else:
            log.info("over-limit shed cache: off (GUBER_SHED_CACHE=0)")

        repl = self.instance.repl
        if repl is not None:
            from gubernator_tpu_torch.serve.replication import footprint_mib

            log.info(
                "bucket replication: on — window %.0f ms, standby "
                "bound %d keys (~%.1f MiB), backlog %d "
                "(GUBER_REPLICATION / GUBER_REPLICATION_SYNC_WAIT_MS / "
                "GUBER_REPLICATION_STANDBY_KEYS / "
                "GUBER_REPLICATION_BACKLOG)",
                repl.sync_wait * 1e3, repl.standby_cap,
                footprint_mib(repl.standby_cap), repl.backlog_cap,
            )
        else:
            log.info("bucket replication: off (GUBER_REPLICATION=0)")

        resc = self.instance.rescale
        if resc is not None:
            log.info(
                "elastic rescale: on — double-serve window %.0f ms, "
                "tracked-key bound %d, flush tick %.0f ms "
                "(GUBER_RESCALE / GUBER_RESCALE_DOUBLE_SERVE_MS / "
                "GUBER_RESCALE_TRACK_KEYS / "
                "GUBER_REPLICATION_SYNC_WAIT_MS)",
                resc.double_serve_s * 1e3, resc.track_cap,
                resc.sync_wait * 1e3,
            )
        else:
            log.info("elastic rescale: off (GUBER_RESCALE=0)")

        ckpt = self.instance.checkpoint
        if ckpt is not None:
            from gubernator_tpu_torch.serve.checkpoint import disk_footprint_mib

            log.info(
                "checkpoint/restore: on — dir %r, interval %.0f ms, "
                "max restore age %.0f s, tracked-key bound %d "
                "(~%.1f MiB on disk), export targets %s "
                "(GUBER_CHECKPOINT_DIR / GUBER_CHECKPOINT_INTERVAL_MS "
                "/ GUBER_CHECKPOINT_MAX_AGE_MS / "
                "GUBER_CHECKPOINT_TRACK_KEYS / "
                "GUBER_CHECKPOINT_EXPORT_PEERS)",
                ckpt.dir, ckpt.sync_wait * 1e3, ckpt.max_age,
                ckpt.track_cap, disk_footprint_mib(ckpt.track_cap),
                ckpt.export_peers or "none",
            )
        else:
            log.info("checkpoint/restore: off (GUBER_CHECKPOINT_DIR unset)")

        if self.conf.geb_port:
            from gubernator_tpu_torch.serve.edge_bridge import GebListener

            self._geb = GebListener(
                self.instance,
                f"0.0.0.0:{self.conf.geb_port}",
                fast_enabled=self.conf.edge_fast,
                window=self.conf.geb_window or self.conf.edge_window,
                string_fold=self.conf.edge_string_fold,
                peer_bridges=_door_map(
                    self.conf.geb_peer_doors, "GUBER_GEB_PEER_DOORS"
                ) or None,
            )
            await self._geb.start()
            log.info(
                "GEB client protocol door on :%d (GUBER_GEB_PORT; "
                "window %d, GUBER_GEB_WINDOW)",
                self.conf.geb_port, self._geb.window,
            )
        if self.conf.http_address:
            await self._start_http()
        if self.conf.edge_socket or self.conf.edge_tcp:
            from gubernator_tpu_torch.serve.edge_bridge import EdgeBridge

            self._edge = EdgeBridge(
                self.instance,
                self.conf.edge_socket,
                tcp_address=self.conf.edge_tcp,
                peer_bridges=_door_map(
                    self.conf.edge_peer_bridges, "GUBER_EDGE_PEER_BRIDGES"
                ),
                fast_enabled=self.conf.edge_fast,
                window=self.conf.edge_window,
                string_fold=self.conf.edge_string_fold,
                max_payload=self.conf.edge_max_frame_mib << 20,
                shm_enabled=self.conf.shm,
                shm_ring_kib=self.conf.shm_ring_kib,
                shm_poll_us=self.conf.shm_poll_us,
            )
            await self._edge.start()
        await self._start_discovery()

    async def drain(self) -> dict:
        """Graceful drain (SIGTERM path), bounded end to end by
        GUBER_DRAIN_TIMEOUT_MS: (0) with rescale on, hand every tracked
        window to the owner the ring elects without this node; (1)
        deregister from discovery; (2) the
        edge bridge and the GEB door answer the frames in flight, then
        refuse new ones with the GEBR drain code; (3) the gRPC server
        and (4) the HTTP gateway stop accepting and let in-flight
        requests finish — every request door is closed BEFORE the queues
        flush, or the batcher's run-dry wait could chase a moving
        target; (5) aggregated GLOBAL hits/updates flush to their
        owners, then (with the managers on) dirty owned windows ship to
        their successors and the final checkpoint is written; (6) the
        device batcher runs dry. Each step gets the
        budget remaining; a step that times out keeps its handle so the
        caller's stop() still hard-closes it. Returns step timings."""
        t0 = time.monotonic()
        budget = getattr(self.conf, "drain_timeout", 5.0)
        deadline = t0 + budget

        def remaining() -> float:
            return max(0.05, deadline - time.monotonic())

        timings = {}

        async def step(name, coro) -> bool:
            t = time.monotonic()
            ok = True
            try:
                await asyncio.wait_for(coro, remaining())
            except asyncio.TimeoutError:
                log.warning("drain step '%s' exceeded the budget", name)
                ok = False
            except Exception as e:
                log.warning("drain step '%s' failed: %s", name, e)
            timings[name] = time.monotonic() - t
            return ok

        if self.instance.rescale is not None:
            # planned-departure handoff BEFORE deregistration: every
            # tracked window ships to the owner the ring elects once this
            # node is gone, so the snapshots are parked on their new
            # owners before any peer's ring flips
            await step("rescale_handoff", self.instance.rescale.drain())
        if self._pool is not None:
            if await step("deregister", self._pool.close()):
                self._pool = None
        # the frame doors drain self-bounded (their poll loop carries the
        # deadline): no wait_for, so none is cancelled mid-refusal
        for name, door in (("edge", self._edge), ("geb", self._geb)):
            if door is not None:
                t = time.monotonic()
                await door.drain(remaining())
                timings[name] = time.monotonic() - t
        if self.conf.http_address:
            # a frame POSTed mid-drain gets the GEBR drain body; the core
            # is built here if no frame came yet, so the first frame that
            # races the drain is refused too
            self._frame_core()._draining = True
        if self.grpc_server is not None:
            # grace makes stop() self-bounding (handlers are
            # force-cancelled when it expires) — and it must NOT run
            # under wait_for: cancelling grpc.aio's stop() mid-flight
            # leaves the server in a state where a LATER stop() can
            # await forever
            t = time.monotonic()
            await self.grpc_server.stop(grace=remaining())
            timings["grpc"] = time.monotonic() - t
            self.grpc_server = None
        if self._http_runner is not None:
            # stops the sites and shuts the app down, finishing
            # in-flight handlers; bounded by the site's shutdown_timeout
            if await step("http", self._http_runner.cleanup()):
                self._http_runner = None
        await step("global_flush", self.instance.global_mgr.drain())
        if self.instance.repl is not None:
            # ship still-dirty owned windows to their successors (and try
            # one handback round) before the batcher runs dry
            await step("replication_flush", self.instance.repl.drain())
        if self.instance.checkpoint is not None:
            # final checkpoint + blue-green export: what is on disk is
            # then at most one in-flight request stale, not one interval
            await step("checkpoint_flush", self.instance.checkpoint.drain())
        await step("batcher", self.instance.batcher.drain())
        timings["total"] = time.monotonic() - t0
        try:
            metrics.DRAIN_DURATION.set(timings["total"])
        except Exception:  # pragma: no cover - defensive
            pass
        log.info(
            "drained in %.0f ms (budget %.0f ms): %s",
            timings["total"] * 1e3, budget * 1e3,
            {k: round(v * 1e3, 1) for k, v in timings.items()},
        )
        return timings

    async def stop(self) -> None:
        if self._edge is not None:
            await self._edge.stop()
            self._edge = None
        if self._geb is not None:
            await self._geb.stop()
            self._geb = None
        self._geb_core = None
        if self._pool is not None:
            await self._pool.close()
            self._pool = None
        if self._http_runner is not None:
            await self._http_runner.cleanup()
            self._http_runner = None
        if self.grpc_server is not None:
            await self.grpc_server.stop(grace=1.0)
            self.grpc_server = None
        await self.instance.stop()
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()  # MultiHostBackend: shut the step pipe

    # -- HTTP gateway -------------------------------------------------------

    async def _start_http(self) -> None:
        app = web.Application()
        app.router.add_post("/v1/GetRateLimits", self._http_get_rate_limits)
        # the binary frame door: one GEB frame per POST body; GET serves
        # the hello (ring + flags) so a client negotiates as on a socket
        app.router.add_post("/v1/geb", self._http_geb)
        app.router.add_get("/v1/geb", self._http_geb_hello)
        app.router.add_get("/v1/HealthCheck", self._http_health)
        app.router.add_get("/metrics", self._http_metrics)
        app.router.add_get("/v1/debug/stats", self._http_debug_stats)
        app.router.add_get("/v1/debug/stages", self._http_debug_stages)
        app.router.add_get("/v1/debug/traces", self._http_debug_traces)
        app.router.add_get("/v1/debug/profile", self._http_debug_profile)
        self._http_runner = web.AppRunner(app)
        await self._http_runner.setup()
        host, _, port = self.conf.http_address.rpartition(":")
        # shutdown_timeout bounds how long cleanup() waits for open
        # connections (aiohttp default: 60s); rate-limit requests are
        # milliseconds of work, so 2s keeps SIGTERM promptly bounded
        site = web.TCPSite(
            self._http_runner, host or "0.0.0.0", int(port),
            shutdown_timeout=2.0,
        )
        await site.start()
        log.info("HTTP listening on %s", self.conf.http_address)

    async def _http_get_rate_limits(self, request: web.Request):
        try:
            body = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            # JSONDecodeError for bad JSON; UnicodeDecodeError for a
            # non-UTF-8 body (raised by aiohttp's .text() underneath)
            return web.json_response({"error": "invalid json"}, status=400)
        # shape-validate before field access: a JSON array or scalar body
        # (or a non-list "requests") is a 400, not a 500
        if not isinstance(body, dict) or not isinstance(
            body.get("requests", []), list
        ):
            return web.json_response(
                {"error": "body must be an object with a 'requests' list"},
                status=400,
            )
        reqs = []
        try:
            for item in body.get("requests", []):
                pb = gubernator_pb2.RateLimitReq(
                    name=item.get("name", ""),
                    unique_key=item.get("uniqueKey", item.get("unique_key", "")),
                    hits=int(item.get("hits", 0)),
                    limit=int(item.get("limit", 0)),
                    duration=int(item.get("duration", 0)),
                    algorithm=_enum_val(
                        gubernator_pb2.Algorithm, item.get("algorithm", 0)
                    ),
                    behavior=_enum_val(
                        gubernator_pb2.Behavior, item.get("behavior", 0)
                    ),
                )
                # hierarchical quota chain: ancestor levels, validated
                # serving-side (instance.chain_error)
                for lv in item.get("chain", []) or []:
                    pb.chain.add(
                        unique_key=str(lv.get("uniqueKey", lv.get("unique_key", ""))),
                        limit=int(lv.get("limit", 0)),
                        duration=int(lv.get("duration", 0)),
                    )
                reqs.append(convert.req_from_pb(pb))
        except (AttributeError, TypeError, ValueError) as e:
            # non-object items, non-numeric int64 fields, bad enum names
            return web.json_response(
                {"error": f"invalid request item: {e}"}, status=400
            )
        # traceparent on the JSON door (r16): an incoming sampled
        # context joins the distributed trace
        tracer = self.instance.tracer
        trace = tracer.join(
            "http",
            tracing.parse_traceparent(request.headers.get(tracing.TRACEPARENT)),
        )
        try:
            with tracing.scope(tracer, trace) as tr:
                if tr is not None:
                    tr.annotate(items=len(reqs))
                resps = await self.instance.get_rate_limits(reqs)
        except BatchTooLargeError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(
            {
                "responses": [
                    {
                        "status": r.status.name,
                        "limit": str(r.limit),
                        "remaining": str(r.remaining),
                        "resetTime": str(r.reset_time),
                        "error": r.error,
                        "metadata": r.metadata,
                    }
                    for r in resps
                ]
            }
        )

    def _frame_core(self):
        """The frame core behind the HTTP binary door: the GEB door when
        it is on (so drain state is shared), else a listenerless
        FrameService over the same instance — either way the decode,
        shed, batch and encode the socket doors run."""
        if self._geb is not None:
            return self._geb
        if self._geb_core is None:
            from gubernator_tpu_torch.serve.edge_bridge import FrameService

            self._geb_core = FrameService(
                self.instance,
                fast_enabled=self.conf.edge_fast,
                window=self.conf.geb_window or self.conf.edge_window,
                string_fold=self.conf.edge_string_fold,
            )
        return self._geb_core

    async def _http_geb_hello(self, request: web.Request):
        return web.Response(
            body=self._frame_core().hello_bytes(),
            content_type=GEB_CONTENT_TYPE,
        )

    async def _http_geb(self, request: web.Request):
        """Binary GEB frame door: the frame protocol with an HTTP body as
        the transport. Content-type gated, so a JSON body posted here
        gets a 415, never a frame decode of its bytes."""
        if request.content_type != GEB_CONTENT_TYPE:
            return web.json_response(
                {
                    "error": (
                        f"content-type must be {GEB_CONTENT_TYPE} "
                        f"(one binary GEB frame per request body)"
                    )
                },
                status=415,
            )
        import struct

        from gubernator_tpu_torch.serve.edge_bridge import MAX_FRAME_PAYLOAD

        # legal frames outgrow aiohttp's 1 MiB client_max_size (a full
        # 65536-item fast frame is ~2.1 MiB), so the raw stream is read
        # under this door's own cap: the socket doors' payload bound
        # plus header slack
        max_body = MAX_FRAME_PAYLOAD + 64
        if (request.content_length or 0) > max_body:
            return web.json_response(
                {"error": "GEB frame exceeds the payload bound"},
                status=413,
            )
        chunks, got = [], 0
        while True:
            chunk = await request.content.read(1 << 16)
            if not chunk:
                break
            got += len(chunk)
            if got > max_body:
                return web.json_response(
                    {"error": "GEB frame exceeds the payload bound"},
                    status=413,
                )
            chunks.append(chunk)
        body = b"".join(chunks)
        try:
            resp = await self._frame_core().serve_frame_bytes(
                body,
                remote_ctx=tracing.parse_traceparent(
                    request.headers.get(tracing.TRACEPARENT)
                ),
            )
        except (ValueError, struct.error) as e:
            # struct.error: a truncated varlen payload that passed the
            # outer length checks — client garbage, still a 400
            return web.json_response(
                {"error": f"bad GEB frame: {e}"}, status=400
            )
        except BatchTooLargeError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.Response(body=resp, content_type=GEB_CONTENT_TYPE)

    async def _http_health(self, request: web.Request):
        h = self.instance.health_check()
        return web.json_response(
            {"status": h.status, "message": h.message, "peerCount": h.peer_count}
        )

    async def _http_metrics(self, request: web.Request):
        self._refresh_store_metrics()
        return web.Response(
            body=metrics.render(), content_type="text/plain", charset="utf-8"
        )

    def _refresh_store_metrics(self) -> None:
        stats = self.backend.stats()
        if "size" in stats:
            metrics.CACHE_SIZE.set(stats["size"])
        metrics.DISTINCT_KEYS.set(self.instance.traffic.hll.estimate())
        # per-peer breaker state gauges refresh at scrape time (state
        # also changes lazily at acquire)
        for peer in self.instance.peer_list():
            if peer.breaker is not None:
                metrics.PEER_BREAKER_STATE.labels(peer=peer.host).set(
                    peer.breaker.state_code
                )
        # shed-cache totals and stage totals export lazily at scrape
        # time: the hot path only bumps plain numbers
        shed = self.instance.shed
        if shed is not None:
            metrics.SHED_HITS.set(shed.hits)
            metrics.SHED_LOOKUPS.set(shed.lookups)
            metrics.SHED_ENTRIES.set(len(shed))
        if self.instance.repl is not None:
            metrics.REPLICATION_STANDBY_ENTRIES.set(self.instance.repl.standby_len)
        snap = STAGES.snapshot()
        for name, s in snap["stages"].items():
            metrics.STAGE_SECONDS.labels(stage=name).set(s["total_s"])
            metrics.STAGE_SAMPLES.labels(stage=name).set(s["count"])
        qs = self.instance.batcher.queue_stats()
        metrics.BATCHER_QUEUE_DEPTH.set(qs["depth"])
        metrics.BATCHER_QUEUE_AGE.set(qs["oldest_age_s"])
        metrics.PREP_BACKLOG.set(qs["prep_backlog"])
        for door, svc in (("edge", self._edge), ("geb", self._geb)):
            if svc is not None:
                metrics.FRAME_INFLIGHT.labels(door=door).set(svc._active_frames)
                metrics.FRAME_CONNECTIONS.labels(door=door).set(len(svc._conns))
        if self.instance.repl is not None:
            metrics.REPLICATION_BACKLOG_ENTRIES.set(self.instance.repl.backlog_len)
        ckpt = self.instance.checkpoint
        if ckpt is not None:
            metrics.CHECKPOINT_TRACKED_ENTRIES.set(ckpt.tracked_len)
            # age refreshes at scrape time (the flush loop only stamps
            # last_ok_ms) so operators see it GROW when writes fail
            age = ckpt.age_seconds
            if age is not None:
                metrics.CHECKPOINT_AGE.set(age)
        if self.instance.rescale is not None:
            metrics.RESCALE_TRACKED_ENTRIES.set(
                self.instance.rescale.tracked_len
                + self.instance.rescale.pending_len
            )
        for queue, size in self.instance.global_mgr.backlog_sizes().items():
            metrics.GLOBAL_BACKLOG_ENTRIES.labels(queue=queue).set(size)
        rec = self.instance.tracer.recorder
        metrics.TRACES_STARTED.set(rec.started)
        metrics.TRACES_RECORDED.set(rec.recorded)
        metrics.TRACES_TAIL_CAPTURED.set(rec.tail_captured)
        metrics.TRACES_DROPPED.set(rec.dropped)
        metrics.TRACE_SLOW_THRESHOLD.set(rec.threshold_ms())

    async def _http_debug_stats(self, request: web.Request):
        """Traffic observability: HLL cardinality + top hot keys + backend
        counters, the launch count of each hand-written kernel in this
        process (core/writeback.py), and the engine's writebacks that no
        decide batch counts (window-install and gossip-charge chunks) with
        the engine's shard counts: launches = n_local_shards x (backend
        batches + install_chunks + gossip_chunks), n_local_shards being the
        shards this process holds (n_shards, unless the mesh spans
        processes). `seg_scan` counts the segmented-scan kernel's calls
        (core/scan.py: every decide and install makes several)."""
        from gubernator_tpu_torch.core.scan import seg_scan
        from gubernator_tpu_torch.core.writeback import writeback_add

        try:
            top_n = int(request.query.get("top", "20"))
        except ValueError:
            return web.json_response(
                {"error": "'top' must be an integer"}, status=400
            )
        body = self.instance.traffic.snapshot(max(top_n, 0))
        body["backend"] = self.backend.stats()
        body["kernel_launches"] = {"writeback_add": writeback_add.launches,
                                   "seg_scan": seg_scan.launches}
        eng = getattr(self.backend, "engine", None)
        if eng is not None:
            body["engine_chunks"] = {
                "install_chunks": eng.install_chunks,
                "gossip_chunks": eng.gossip_chunks,
                "n_shards": eng.n,
                "n_local_shards": eng.n_local,
            }
            # the card's time inside counted decides (CUDA events around
            # each; 0 on the CPU): 1 - its growth over a window's wall time
            # bounds the device's idle share from below
            body["device_span_ms"] = eng.device_span_ms
            # the engine's captured decides (core/graphs.py; a mesh's summed
            # over its devices, this process's): how many, how many were
            # captured on first use since the boot's warmup (0 once every
            # shape was warmed), and the warmup's capture s
            body["decide_graphs"] = {
                "count": getattr(eng, "graph_count", 0),
                "captures": getattr(eng, "graph_captures", 0),
                "capture_s": getattr(eng, "capture_s", 0.0),
            }
            # its captured installs, GLOBAL steps and reads likewise; the
            # programs the reference too compiles only on first use (full
            # installs, reads past the warmup's rungs) count apart
            body["program_graphs"] = {
                "count": getattr(eng, "program_graph_count", 0),
                "captures": getattr(eng, "program_captures", 0),
                "first_use_captures": getattr(eng, "first_use_captures", 0),
                "capture_s": getattr(eng, "program_capture_s", 0.0),
            }
        promoter = getattr(self.instance, "promoter", None)
        if promoter is not None:
            # the top-k fold's graph: captured when the promoter was built
            body["topk_graph"] = promoter.tracker.ss.graph_stats()
        return web.json_response(body)

    async def _http_debug_stages(self, request: web.Request):
        """Serving-pipeline stage attribution (serve/stages.py): where
        one served decision's wall time goes — batcher queue, device
        span with its submit/fetch split — plus the shed-cache counters.
        `?reset=1` zeroes the accumulators (scopes a measurement
        window)."""
        shed = self.instance.shed
        if request.query.get("reset") in ("1", "true"):
            STAGES.reset()
            if shed is not None:
                shed.reset_counters()
        body = STAGES.snapshot()
        if shed is not None:
            body["shed_cache"] = shed.stats()
        return web.json_response(body)

    async def _http_debug_traces(self, request: web.Request):
        """The flight recorder (serve/tracing.py): completed sampled +
        tail-captured traces, newest last. `?id=<32-hex>` fetches one
        trace (404 when it aged out); `?limit=N` bounds the listing
        (default 64); `?reset=1` clears the ring and counters."""
        rec = self.instance.tracer.recorder
        if request.query.get("reset") in ("1", "true"):
            rec.reset()
        tid = request.query.get("id", "")
        if tid:
            doc = rec.get(tid)
            if doc is None:
                return web.json_response(
                    {"error": f"no retained trace with id '{tid}'"},
                    status=404,
                )
            return web.json_response(doc)
        try:
            limit = int(request.query.get("limit", "64"))
        except ValueError:
            return web.json_response(
                {"error": "'limit' must be an integer"}, status=400
            )
        body = rec.snapshot(limit=max(0, limit))
        body["sample"] = self.instance.tracer.sample
        body["slow_ms"] = self.instance.tracer.slow_ms
        return web.json_response(body)

    async def _http_debug_profile(self, request: web.Request):
        """Capture a torch.profiler trace (host ops, and the device's
        kernels and copies when a GPU serves) for ?ms= milliseconds
        (default 1000), written as a Chrome trace under
        PROFILE_DIR/<?name=>/trace.json (?name= is a single path
        component, default "trace"); view it in Perfetto."""
        try:
            ms = int(request.query.get("ms", "1000"))
        except ValueError:
            return web.json_response(
                {"error": "'ms' must be an integer"}, status=400
            )
        ms = max(0, min(ms, 60_000))
        # `name` is a single path component under a fixed base — this is
        # the only write-capable endpoint on the HTTP surface
        name = request.query.get("name", "trace")
        if os.path.basename(name) != name or name in ("", ".", ".."):
            return web.json_response(
                {"error": "'name' must be a bare directory name"}, status=400
            )
        out_dir = os.path.join(PROFILE_DIR, name)
        if self._profiling:
            return web.json_response(
                {"error": "profile already in progress"}, status=409
            )
        self._profiling = True
        prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            await asyncio.sleep(ms / 1000.0)
        except Exception as e:
            return web.json_response(
                {"error": f"profiler unavailable: {e}"}, status=501
            )
        finally:
            # stop even on client disconnect (CancelledError) so the
            # endpoint is usable again without a restart
            if prof is not None:
                try:
                    prof.stop()
                    os.makedirs(out_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
                except Exception:
                    log.exception("profiler stop/export failed")
            self._profiling = False
        return web.json_response({"trace_dir": out_dir, "captured_ms": ms})

    # -- discovery ----------------------------------------------------------

    async def _start_discovery(self) -> None:
        advertise = self.conf.resolved_advertise()
        if self.conf.etcd_endpoints:
            from gubernator_tpu_torch.serve.discovery import EtcdPool

            self._pool = EtcdPool(
                endpoints=self.conf.etcd_endpoints,
                prefix=self.conf.etcd_prefix,
                advertise=advertise,
                on_update=self._on_peers,
                tls_cert=self.conf.etcd_tls_cert,
                tls_key=self.conf.etcd_tls_key,
                tls_ca=self.conf.etcd_tls_ca,
            )
        elif self.conf.k8s_endpoints_selector:
            from gubernator_tpu_torch.serve.discovery import K8sPool

            self._pool = K8sPool(
                namespace=self.conf.k8s_namespace,
                selector=self.conf.k8s_endpoints_selector,
                pod_ip=self.conf.k8s_pod_ip,
                pod_port=self.conf.k8s_pod_port,
                on_update=self._on_peers,
            )
        else:
            from gubernator_tpu_torch.serve.discovery import StaticPool

            self._pool = StaticPool(
                peers=self.conf.peers or [advertise],
                advertise=advertise,
                on_update=self._on_peers,
            )
        await self._pool.start()

    async def _on_peers(self, peers) -> None:
        await self.instance.set_peers(peers)


def _door_map(spec: str, knob: str) -> dict:
    """'grpc_addr=door_addr,...' (GUBER_GEB_PEER_DOORS,
    GUBER_EDGE_PEER_BRIDGES) -> {grpc_addr: door_addr}."""
    doors = {}
    for pair in spec.split(","):
        if not pair.strip():
            continue
        grpc_addr, sep, door = pair.strip().partition("=")
        if not sep or not grpc_addr or not door:
            raise ValueError(
                f"{knob} entries must be 'grpc_addr=door_addr', got {pair!r}"
            )
        doors[grpc_addr] = door
    return doors


def _enum_val(enum_pb, v):
    if isinstance(v, str):
        return enum_pb.Value(v)
    return int(v)


async def run_daemon(conf: ServerConfig, device: DeviceLike = None) -> None:
    """Start a server on `device` (cuda unless the caller asks for
    another) and run until SIGINT/SIGTERM (reference
    cmd/gubernator/main.go:127-139). SIGTERM (the orchestrated-shutdown
    signal) drains gracefully — deregister, finish in-flight work, flush
    GLOBAL + batcher queues — bounded by GUBER_DRAIN_TIMEOUT_MS; SIGINT
    stops immediately."""
    import signal
    import threading

    server = Server(conf, device=device)
    await server.start()
    stop = asyncio.Event()
    graceful: list = []
    drain_task: list = []
    loop = asyncio.get_running_loop()

    def on_term():
        # second SIGTERM = the supervisor is impatient: abandon the
        # drain and hard-stop now
        if graceful:
            graceful.clear()
            for t in drain_task:
                t.cancel()
        graceful.append(True)
        stop.set()

    loop.add_signal_handler(signal.SIGINT, stop.set)
    loop.add_signal_handler(signal.SIGTERM, on_term)
    await stop.wait()

    # shutdown watchdog on a plain THREAD (immune to a wedged event
    # loop): a signalled daemon exits within a bound, even when a
    # teardown await never returns
    def _force_exit():
        log.error("shutdown watchdog fired (teardown wedged); forcing exit")
        logging.shutdown()
        os._exit(1)

    watchdog = threading.Timer(
        2 * getattr(conf, "drain_timeout", 5.0) + 10.0, _force_exit
    )
    watchdog.daemon = True
    watchdog.start()
    if graceful:
        log.info("SIGTERM: draining")
        drain_task.append(asyncio.ensure_future(server.drain()))
        try:
            await drain_task[0]
        except asyncio.CancelledError:
            log.warning("drain aborted (second SIGTERM)")
    log.info("shutting down")
    await server.stop()
    watchdog.cancel()
