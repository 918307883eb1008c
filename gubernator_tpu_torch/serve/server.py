"""Server daemon: gRPC V1 + PeersV1 services, HTTP JSON gateway, /metrics
(the port of gubernator_tpu/serve/server.py).

Wires config -> backend -> Instance -> servers, mirroring the reference
daemon's shape (reference cmd/gubernator/main.go:40-147): gRPC on one
listener, an HTTP gateway exposing POST /v1/GetRateLimits and
GET /v1/HealthCheck as JSON plus GET /metrics for Prometheus, static
discovery pushing the peer list into Instance.set_peers, and graceful
shutdown. The backend is the port's own (serve/backends.make_backend) on
`device`: cuda unless the caller asks for another.

Not ported yet, and refused when the server is built rather than
ignored (`refuse_not_ported`): the GEB client-protocol door and the
native edge bridge (GUBER_GEB_PORT, GUBER_EDGE_SOCKET, GUBER_EDGE_TCP),
etcd and Kubernetes discovery, and the multi-host mesh
(GUBER_DIST_COORDINATOR); `make_backend` refuses the backends and the
Instance the managers that are not ported. PeersV1.ReplicateBuckets
answers UNIMPLEMENTED.
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
from gubernator_tpu_torch.core.store import DeviceLike
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.backends import make_backend
from gubernator_tpu_torch.serve.config import ServerConfig
from gubernator_tpu_torch.serve.instance import BatchTooLargeError, Instance
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.server")


def refuse_not_ported(conf: ServerConfig) -> None:
    """Raise ValueError naming every door or manager the config selects
    that the port does not carry yet."""
    asked = [
        name
        for name, on in (
            ("GUBER_GEB_PORT (the GEB client-protocol door)", conf.geb_port),
            ("GUBER_EDGE_SOCKET / GUBER_EDGE_TCP (the native edge bridge)",
             conf.edge_socket or conf.edge_tcp),
            ("GUBER_ETCD_ENDPOINTS (etcd discovery)", conf.etcd_endpoints),
            ("GUBER_K8S_ENDPOINTS_SELECTOR (Kubernetes discovery)",
             conf.k8s_endpoints_selector),
            ("GUBER_DIST_COORDINATOR (the multi-host mesh)",
             conf.dist_coordinator),
        )
        if on
    ]
    if asked:
        raise ValueError(
            "not ported to gubernator_tpu_torch yet: " + "; ".join(asked)
        )


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
        await context.abort(
            grpc.StatusCode.UNIMPLEMENTED,
            "bucket replication (ReplicateBuckets) is not ported to "
            "gubernator_tpu_torch yet",
        )


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


class Server:
    """One daemon: gRPC + HTTP, an Instance, and discovery."""

    _profiling = False

    def __init__(
        self, conf: ServerConfig, backend=None, device: DeviceLike = None
    ):
        refuse_not_ported(conf)
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

        if self.conf.http_address:
            await self._start_http()
        await self._start_discovery()

    async def drain(self) -> dict:
        """Graceful drain (SIGTERM path), bounded end to end by
        GUBER_DRAIN_TIMEOUT_MS: (1) deregister from discovery; (2) the
        gRPC server and (3) the HTTP gateway stop accepting and let
        in-flight requests finish — every request door is closed BEFORE
        the queues flush, or the batcher's run-dry wait could chase a
        moving target; (4) aggregated GLOBAL hits/updates flush to their
        owners; (5) the device batcher runs dry. Each step gets the
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

        if self._pool is not None:
            if await step("deregister", self._pool.close()):
                self._pool = None
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

    # -- HTTP gateway -------------------------------------------------------

    async def _start_http(self) -> None:
        app = web.Application()
        app.router.add_post("/v1/GetRateLimits", self._http_get_rate_limits)
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
                # quota chain levels parse as at the reference's door, so
                # a chained item gets its per-item "not ported" answer
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
        snap = STAGES.snapshot()
        for name, s in snap["stages"].items():
            metrics.STAGE_SECONDS.labels(stage=name).set(s["total_s"])
            metrics.STAGE_SAMPLES.labels(stage=name).set(s["count"])
        qs = self.instance.batcher.queue_stats()
        metrics.BATCHER_QUEUE_DEPTH.set(qs["depth"])
        metrics.BATCHER_QUEUE_AGE.set(qs["oldest_age_s"])
        metrics.PREP_BACKLOG.set(qs["prep_backlog"])
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
        decide batch counts (window-install and gossip-charge chunks):
        launches = backend batches + install_chunks + gossip_chunks."""
        from gubernator_tpu_torch.core.writeback import writeback_add

        try:
            top_n = int(request.query.get("top", "20"))
        except ValueError:
            return web.json_response(
                {"error": "'top' must be an integer"}, status=400
            )
        body = self.instance.traffic.snapshot(max(top_n, 0))
        body["backend"] = self.backend.stats()
        body["kernel_launches"] = {"writeback_add": writeback_add.launches}
        eng = getattr(self.backend, "engine", None)
        if eng is not None:
            body["engine_chunks"] = {
                "install_chunks": eng.install_chunks,
                "gossip_chunks": eng.gossip_chunks,
            }
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
        from gubernator_tpu_torch.serve.discovery import StaticPool

        advertise = self.conf.resolved_advertise()
        self._pool = StaticPool(
            peers=self.conf.peers or [advertise],
            advertise=advertise,
            on_update=self._on_peers,
        )
        await self._pool.start()

    async def _on_peers(self, peers) -> None:
        await self.instance.set_peers(peers)


def _enum_val(enum_pb, v):
    if isinstance(v, str):
        return enum_pb.Value(v)
    return int(v)


async def run_daemon(conf: ServerConfig) -> None:
    """Start a server and run until SIGINT/SIGTERM (reference
    cmd/gubernator/main.go:127-139). SIGTERM (the orchestrated-shutdown
    signal) drains gracefully — deregister, finish in-flight work, flush
    GLOBAL + batcher queues — bounded by GUBER_DRAIN_TIMEOUT_MS; SIGINT
    stops immediately."""
    import signal
    import threading

    server = Server(conf)
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
