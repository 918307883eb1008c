"""The port's doors and multi-node forwarding against the JAX package's,
on the CPU.

The port's `LocalCluster` (6 nodes, each a `TorchBackend(device="cpu")`)
and the JAX `LocalCluster` (each a `TpuBackend`, the small store and rungs
of tests/test_functional.py) are started in turn on the same free ports
(ring ownership hashes the address strings, so both route alike) and
driven through real sockets by the same script:

- the functional cases of tests/test_functional.py: health, over the
  limit, token window reset, leaky drain, missing fields, batch too
  large, forwarding with owner metadata, NO_BATCHING forwarding, GLOBAL
  convergence, bad-peer health, and (on a 3-node cluster of each) the
  dead owner's per-item error;
- the HTTP gateway cases of tests/test_http_gateway.py on node 0's JSON
  door, and the metric names /metrics exposes after the traffic.

One pinned clock serves both packages (windows move by advancing it, not
by sleeping), the JAX side hashes keys on its pure-Python path (the
port's), and requests go one at a time. The gRPC responses must be
identical protobuf messages, the HTTP bodies identical JSON; the only
exception is the tail of the dead owner's error, which quotes the gRPC
library's own error text. Tolerance is zero.
"""

import json
import time
import urllib.error
import urllib.request

import grpc
import pytest

import gubernator_tpu.api.types as j_types
import gubernator_tpu.core.engine as j_engine
import gubernator_tpu_torch.api.types as t_types
from test_torch_hash import pin_hash
from _util import free_ports
from gubernator_tpu.cluster import LocalCluster as JLocalCluster
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.serve.backends import TpuBackend
from gubernator_tpu_torch.api import convert
from gubernator_tpu_torch.api.grpc_glue import V1Stub
from gubernator_tpu_torch.api.proto.gen import gubernator_pb2
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    PeerInfo,
    RateLimitReq,
)
from gubernator_tpu_torch.cluster import LocalCluster
from gubernator_tpu_torch.core.hashing import ring_hash
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import TorchBackend

T0 = 1_700_000_000_000
BUCKETS = (64, 256, 1024)  # tests/test_functional.py:34-37

#: metric families of features the port does not carry yet: the JAX
#: package may expose them, the port must not. Empty since the durability
#: managers (replication, rescale, checkpoint) were ported with their
#: series
UNPORTED_METRICS = ()


class FakeClock:
    def __init__(self):
        self.t = T0

    def __call__(self) -> int:
        return self.t


def _torch_backend():
    return TorchBackend(StoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS, device="cpu")


def _jax_backend():
    return TpuBackend(JStoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS)


def owner_index(key: str, addresses) -> int:
    """Which node owns this ring key (hash.go successor rule)."""
    points = sorted((ring_hash(a), a) for a in addresses)
    h = ring_hash(key)
    for point, addr in points:
        if point >= h:
            return addresses.index(addr)
    return addresses.index(points[0][1])


def _non_owned(prefix: str, addresses, node: int = 0) -> str:
    return next(f"account:{i}" for i in range(1000)
                if owner_index(f"{prefix}_account:{i}", addresses) != node)


def _req(name, key, **kw):
    kw.setdefault("hits", 1)
    return RateLimitReq(name=name, unique_key=key, **kw)


class Caller:
    """Sends GetRateLimits / HealthCheck to a node over one channel and
    records every answer as serialized protobuf."""

    def __init__(self, target):
        self.channel = grpc.insecure_channel(target)
        self.stub = V1Stub(self.channel)

    def rl(self, reqs):
        pb = gubernator_pb2.GetRateLimitsReq(requests=[convert.req_to_pb(r) for r in reqs])
        try:
            return self.stub.GetRateLimits(pb, timeout=15)
        except grpc.RpcError as e:
            return ("rpc error", e.code().name, e.details())

    def health(self):
        return self.stub.HealthCheck(gubernator_pb2.HealthCheckReq(), timeout=5)

    def close(self):
        self.channel.close()


def _functional_cases(cluster, clock, addresses):
    """The functional cases, in order; returns {case: [answers]}."""
    out = {}
    d0 = Caller(addresses[0])
    d = Caller(addresses[3])  # the reference's "any peer"
    try:
        out["health_check"] = [d.health()]

        def tok(key, **kw):
            return _req("test_over_limit", key, algorithm=Algorithm.TOKEN_BUCKET,
                        duration=1000, limit=2, **kw)

        out["over_the_limit"] = [d.rl([tok("account:1234")]) for _ in range(3)]

        def window():
            return d.rl([_req("test_token_bucket", "account:1234", duration=25, limit=2)])

        r = [window(), window()]
        clock.t += 30
        out["token_window_reset"] = r + [window()]

        def leaky(hits):
            return d.rl([_req("test_leaky_bucket", "account:1234",
                              algorithm=Algorithm.LEAKY_BUCKET, duration=2000,
                              limit=5, hits=hits)])

        r = [leaky(5), leaky(1)]
        clock.t += 450  # one token leaks back
        r.append(leaky(1))
        clock.t += 850  # two more
        out["leaky_drain"] = r + [leaky(1)]

        out["missing_fields"] = [d.rl([r]) for r in (
            _req("test_missing_fields", "account:1234", limit=10, duration=0),
            _req("test_missing_fields", "account:12345", duration=10_000, limit=0),
            _req("", "account:1234", duration=10_000, limit=5),
            _req("test_missing_fields", "", duration=10_000, limit=5),
        )]
        out["batch_too_large"] = [d.rl([
            _req("too_big", f"k{i}", limit=10, duration=1000) for i in range(1001)
        ])]
        key = _non_owned("test_forward", addresses)
        out["forwarding_sets_owner_metadata"] = [
            d0.rl([_req("test_forward", key, limit=10, duration=1000)]) for _ in range(2)
        ]
        key = _non_owned("test_nobatch", addresses)
        out["no_batching_forwarding"] = [
            d0.rl([_req("test_nobatch", key, limit=10, duration=1000,
                        behavior=Behavior.NO_BATCHING)]) for _ in range(2)
        ]
        # mixed: owned and forwarded items (BATCHING and NO_BATCHING) of
        # all four algorithms in one request (GLOBAL replicas follow the
        # real-time gossip loops, so they have their own case below);
        # every third key is node 0's own, whatever the ring's arcs
        owned = (n for n in range(100_000) if owner_index(f"test_mixed_m{n}", addresses) == 0)
        other = (n for n in range(100_000) if owner_index(f"test_mixed_m{n}", addresses) != 0)
        mixed = [
            _req("test_mixed", f"m{next(owned if i % 3 == 0 else other)}", limit=5,
                 duration=60_000, algorithm=Algorithm(i % 4), behavior=Behavior(i // 4 % 2))
            for i in range(24)
        ]
        r = []
        for step in (0, 0, 7):
            clock.t += step
            r.append(d0.rl(mixed))
        out["mixed_owner_split"] = r

        key = _non_owned("test_global", addresses)

        def glob():
            return d0.rl([_req("test_global", key, algorithm=Algorithm.TOKEN_BUCKET,
                               behavior=Behavior.GLOBAL, duration=3000, limit=5)])

        r = [glob(), glob()]
        time.sleep(0.5)  # the gossip interval (real time: the loops sleep)
        out["global_rate_limits"] = r + [glob()]

        inst = cluster.servers[0].instance
        good = [PeerInfo(address=a, is_owner=(a == addresses[0])) for a in addresses]
        cluster.run(inst.set_peers(good + [PeerInfo(address="not-an-address:-1")]))
        r = [d0.health()]
        cluster.run(inst.set_peers(good))
        out["health_unhealthy_on_bad_peer"] = r + [d0.health()]
    finally:
        d.close()
        d0.close()
    return out


def _http(base, path, body=None):
    """(status, decoded JSON) of a GET, or of a POST of `body`."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_cases(base, addresses):
    out = {}
    body = {"requests": [{
        "name": "gw", "uniqueKey": "account:7", "hits": "1", "limit": 2,
        "duration": 60000, "algorithm": "TOKEN_BUCKET",
    }]}
    out["json_round_trip"] = [_http(base, "/v1/GetRateLimits", body) for _ in range(3)]
    out["per_item_validation_errors"] = [_http(base, "/v1/GetRateLimits", {"requests": [
        {"name": "", "uniqueKey": "k", "hits": 1, "limit": 5, "duration": 1000},
        {"name": "gw2", "uniqueKey": "", "hits": 1, "limit": 5, "duration": 1000},
        {"name": "gw2", "uniqueKey": "ok", "hits": 1, "limit": 5, "duration": 1000},
    ]})]
    out["malformed_body_is_client_error"] = [_http(base, "/v1/GetRateLimits", p) for p in (
        b"{not json", b"[]", b'{"requests": "nope"}', b'{"requests": [42]}',
        b'{"requests": [{"name": "a", "uniqueKey": "b", "hits": "zz"}]}',
        b"\xff\xfe\x00bad utf8",
    )]
    # a key per behavior: one key's batched and direct forwards would
    # reach its owner in an order the run picks; the pause lets the
    # GLOBAL hit reach its owner and the owner's broadcast come back
    fwd = [k for k in (f"account:{i}" for i in range(1000))
           if owner_index(f"gwf_{k}", addresses) != 0][:3]
    body = {"requests": [
        {"name": "gwf", "uniqueKey": k, "hits": 1, "limit": 3, "duration": 60000,
         "behavior": b} for k, b in zip(fwd, ("BATCHING", "NO_BATCHING", "GLOBAL"))
    ]}
    first = _http(base, "/v1/GetRateLimits", body)
    time.sleep(0.5)  # the gossip interval, as in the GLOBAL functional case
    out["forwarded_item_names_its_owner"] = [first, _http(base, "/v1/GetRateLimits", body)]
    out["health_route"] = [_http(base, "/v1/HealthCheck")]
    status, stats = _http(base, "/v1/debug/stats")
    # the port adds its kernel launch count, the engine's install and
    # gossip chunks (the launches no decide batch counts), the card's
    # time inside decides, its captured decide graphs, its other captured
    # programs and the promoter's top-k fold graph
    port_only = ("kernel_launches", "engine_chunks", "device_span_ms", "decide_graphs",
                 "program_graphs", "topk_graph")
    out["debug_stats_route"] = [(status, sorted(k for k in stats if k not in port_only),
                                 stats["distinct_keys_estimate"])]
    return out


def _metric_names(base):
    with urllib.request.urlopen(base + "/metrics", timeout=15) as r:
        text = r.read().decode()
    names = set()
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            names.add(ln.split("{")[0].split(" ")[0])
    return names


class Ports:
    """free_ports for the first run, recorded; the same ports in the same
    order for the second, so both packages' clusters stand on one ring."""

    def __init__(self):
        self.drawn = []
        self.replay = None

    def __call__(self, n):
        if self.replay is not None:
            return self.replay.pop(0)
        got = free_ports(n)
        self.drawn.append(got)
        return got

    def rewind(self):
        self.replay = list(self.drawn)


def _dead_owner(cls, factory, clock, ports):
    """A 3-node cluster whose node 2 dies after joining the ring: node 0
    answers its keys with a per-item error, a live node's key normally."""
    addresses = [f"127.0.0.1:{p}" for p in ports(3)]
    c = cls(addresses, backend_factory=factory)
    c.start()
    try:
        for s in c.servers:
            s.instance.shed.now_fn = clock

        def owned_by(node):
            return next(f"deadfwd_{n}" for n in range(10_000)
                        if owner_index(f"dead_deadfwd_{n}", addresses) == node)

        c.run(c.servers[2].stop())
        d = Caller(addresses[0])
        try:
            resp = d.rl([_req("dead", owned_by(2), limit=5, duration=1000),
                         _req("dead", owned_by(0), limit=5, duration=1000)])
        finally:
            d.close()
    finally:
        c.stop()
    # the error's tail quotes the gRPC library's message (addresses,
    # timestamps): compare up to it
    for r in resp.responses:
        if r.error:
            r.error = r.error.split(" from peer - ")[0] + " from peer"
    return resp


def _drive(cls, factory, clock, ports):
    g = ports(6)
    h = ports(1)[0]
    addresses = [f"127.0.0.1:{p}" for p in g]
    c = cls(addresses, backend_factory=factory,
            http_addresses=[f"127.0.0.1:{h}"] + [""] * 5)
    c.start()
    try:
        for s in c.servers:
            s.instance.shed.now_fn = clock
        out = _functional_cases(c, clock, addresses)
        base = f"http://127.0.0.1:{h}"
        http = _http_cases(base, addresses)
        names = _metric_names(base)
    finally:
        c.stop()
    out["dead_owner_forward_fails_per_item"] = [_dead_owner(cls, factory, clock, ports)]
    return out, http, names, addresses


@pytest.fixture(scope="module")
def runs():
    """Both packages through the same script, the port first, on the same
    ports and under one pinned clock."""
    results = {}
    ports = Ports()
    with pytest.MonkeyPatch.context() as mp:
        clock = FakeClock()
        mp.setattr(j_types, "millisecond_now", clock)
        mp.setattr(j_engine, "millisecond_now", clock, raising=False)
        mp.setattr(t_types, "millisecond_now", clock)
        pin_hash(mp, "blake2b")  # both packages on one slot hash
        for name, cls, factory in (("torch", LocalCluster, _torch_backend),
                                   ("jax", JLocalCluster, _jax_backend)):
            clock.t = T0
            results[name] = _drive(cls, factory, clock, ports)
            ports.rewind()
    return results


FUNCTIONAL = [
    "health_check", "over_the_limit", "token_window_reset", "leaky_drain",
    "missing_fields", "batch_too_large", "forwarding_sets_owner_metadata",
    "no_batching_forwarding", "mixed_owner_split", "global_rate_limits",
    "health_unhealthy_on_bad_peer", "dead_owner_forward_fails_per_item",
]


def _rows(answers):
    """Comparable form: serialized protobuf, or the RPC error tuple."""
    return [a if isinstance(a, tuple) else (type(a).__name__, a.SerializeToString(
        deterministic=True)) for a in answers]


def _resps(answer):
    return [(r.status, r.limit, r.remaining, r.error, dict(r.metadata))
            for r in answer.responses]


#: what each case must show (the reference's functional contract), on
#: the port's answers
CHECK = {
    "health_check": lambda a, ad: (a[0].status, a[0].peer_count) == ("healthy", 6),
    "over_the_limit": lambda a, ad: [_resps(x)[0][:4] for x in a] == [
        (0, 2, 1, ""), (0, 2, 0, ""), (1, 2, 0, "")],
    "token_window_reset": lambda a, ad: [_resps(x)[0][2] for x in a] == [1, 0, 1],
    "leaky_drain": lambda a, ad: [_resps(x)[0][:3:2] for x in a] == [
        (0, 0), (1, 0), (0, 0), (0, 1)],
    "missing_fields": lambda a, ad: [_resps(x)[0][3] for x in a] == [
        "", "", "field 'namespace' cannot be empty", "field 'unique_key' cannot be empty"]
        and [_resps(x)[0][0] for x in a] == [0, 1, 0, 0],
    "batch_too_large": lambda a, ad: a[0][:2] == ("rpc error", "OUT_OF_RANGE"),
    "forwarding_sets_owner_metadata": lambda a, ad: [_resps(x)[0][2] for x in a] == [9, 8]
        and all(_resps(x)[0][4]["owner"] in ad[1:] for x in a),
    "no_batching_forwarding": lambda a, ad: [_resps(x)[0][2] for x in a] == [9, 8]
        and all("owner" in _resps(x)[0][4] for x in a),
    "mixed_owner_split": lambda a, ad: all(r[3] == "" for x in a for r in _resps(x))
        and any("owner" in r[4] for r in _resps(a[0]))
        and any("owner" not in r[4] for r in _resps(a[0])),
    "global_rate_limits": lambda a, ad: [_resps(x)[0][2] for x in a] == [4, 4, 3],
    "health_unhealthy_on_bad_peer": lambda a, ad: a[0].status == "unhealthy"
        and "not-an-address:-1" in a[0].message and a[0].peer_count == 6
        and a[1].status == "healthy",
    "dead_owner_forward_fails_per_item": lambda a, ad:
        "while fetching rate limit" in _resps(a[0])[0][3]
        and _resps(a[0])[1][:4] == (0, 5, 4, ""),
}


@pytest.mark.parametrize("case", FUNCTIONAL)
def test_functional_case_matches_jax(runs, case):
    t, j = runs["torch"][0][case], runs["jax"][0][case]
    assert _rows(t) == _rows(j)
    assert runs["torch"][3] == runs["jax"][3]  # one ring for both
    assert CHECK[case](t, runs["torch"][3]), t


HTTP = [
    "json_round_trip", "per_item_validation_errors", "malformed_body_is_client_error",
    "forwarded_item_names_its_owner", "health_route", "debug_stats_route",
]


@pytest.mark.parametrize("case", HTTP)
def test_http_case_matches_jax(runs, case):
    t, j = runs["torch"][1][case], runs["jax"][1][case]
    assert t == j
    if case == "json_round_trip":
        got = [(s, b["responses"][0]["status"], b["responses"][0]["remaining"]) for s, b in t]
        assert got == [(200, "UNDER_LIMIT", "1"), (200, "UNDER_LIMIT", "0"),
                       (200, "OVER_LIMIT", "0")]
    elif case == "malformed_body_is_client_error":
        assert all(400 <= s < 500 for s, _ in t)
    elif case == "forwarded_item_names_its_owner":
        first = t[0][1]["responses"]
        assert "owner" in first[0]["metadata"] and "owner" in first[1]["metadata"]
        assert first[2]["metadata"] == {}  # a GLOBAL replica answer


def test_metric_names_match_jax_less_unported_features(runs):
    t, j = runs["torch"][2], runs["jax"][2]
    assert not {n for n in t if n.startswith(UNPORTED_METRICS)}
    assert t == {n for n in j if not n.startswith(UNPORTED_METRICS)}
    assert {"replication_snapshots_sent_total", "rescale_keys_moved_total",
            "restored_windows_total"} <= t
    for name in ("device_batch_size_count", "grpc_request_duration_milliseconds_count",
                 "store_dropped_creates_total", "store_evictions_total", "shed_entries"):
        assert name in t


def test_daemon_without_a_gpu_exits_nonzero_with_the_engines_message():
    """The daemon serves on the CUDA device and has no CPU fallback: with
    no GPU visible it exits non-zero, naming the way to ask for the CPU."""
    import os
    import subprocess
    import sys

    g, h = free_ports(2)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GUBER_STORE_MIB="8",
               GUBER_GRPC_ADDRESS=f"127.0.0.1:{g}", GUBER_HTTP_ADDRESS=f"127.0.0.1:{h}")
    r = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cli.daemon"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("knob", [
    "GUBER_DIST_COORDINATOR=127.0.0.1:7002",
    "GUBER_BACKEND=mesh", "GUBER_BACKEND=multihost",
])
def test_mesh_and_multihost_knobs_build_a_server(knob):
    """The knobs once refused build a Server, as the JAX package's do (the
    doors open at start(), which this does not call):
    GUBER_DIST_COORDINATOR is the daemon's to act on (cli/daemon.py joins
    the process group before it builds the Server), so the Server builds
    its configured backend; GUBER_BACKEND=mesh a MeshBackend
    (GUBER_SHARDS=2 on the CPU); GUBER_BACKEND=multihost, with no process
    group joined, a MultiHostBackend over a one-process mesh of the CPU
    with no step pipe."""
    from gubernator_tpu_torch.serve.backends import MeshBackend, MultiHostBackend, TorchBackend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    key, _, value = knob.partition("=")
    env = {"GUBER_GRPC_ADDRESS": "127.0.0.1:7003", "GUBER_STORE_MIB": "8", key: value}
    if key == "GUBER_DIST_COORDINATOR":
        env.update(GUBER_BACKEND="tpu", GUBER_DIST_NUM_PROCESSES="2")
        server = Server(config_from_env(env), device="cpu")
        assert isinstance(server.backend, TorchBackend)
        assert server.conf.dist_coordinator == "127.0.0.1:7002"
        return
    if value == "mesh":
        server = Server(config_from_env(dict(env, GUBER_SHARDS="2")), device="cpu")
        assert isinstance(server.backend, MeshBackend) and server.backend.engine.n == 2
        return
    server = Server(config_from_env(env), device="cpu")
    assert isinstance(server.backend, MultiHostBackend)
    assert server.backend.engine.pipe is None and server.backend.engine.n == 1
    server.backend.close()  # no pipe: nothing to shut


@pytest.mark.parametrize("knob", [
    "GUBER_GEB_PORT=7000", "GUBER_EDGE_SOCKET=/nonexistent/e.sock",
    "GUBER_EDGE_TCP=127.0.0.1:7001",
])
def test_frame_doors_are_no_longer_refused_at_boot(knob):
    """The GEB door and the edge bridge are ported: their knobs build a
    Server (the doors open at start(), which this does not call)."""
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    key, _, value = knob.partition("=")
    conf = config_from_env(
        {"GUBER_GRPC_ADDRESS": "127.0.0.1:7003", "GUBER_STORE_MIB": "8", key: value}
    )
    Server(conf, device="cpu")


@pytest.mark.parametrize("knob", [
    "GUBER_ETCD_ENDPOINTS=127.0.0.1:<dead>", "GUBER_K8S_ENDPOINTS_SELECTOR=app=guber",
])
def test_discovery_knobs_are_no_longer_refused_at_boot(knob):
    """etcd and Kubernetes discovery are ported: a Server builds with
    either knob and contacts neither etcd nor the API server before
    start() (the pool is made there; a dead etcd endpoint costs nothing
    here)."""
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    (dead,) = free_ports(1)
    key, _, value = knob.partition("=")
    conf = config_from_env({"GUBER_GRPC_ADDRESS": "127.0.0.1:7003", "GUBER_STORE_MIB": "8",
                            key: value.replace("<dead>", str(dead))})
    assert conf.etcd_endpoints or conf.k8s_endpoints_selector
    server = Server(conf, device="cpu")
    assert server._pool is None


@pytest.mark.parametrize("knob", [
    "GUBER_REPLICATION=1", "GUBER_RESCALE=1", "GUBER_CHECKPOINT_DIR=<tmp>",
    "GUBER_CHECKPOINT_EXPORT_PEERS=127.0.0.1:<dead>", "GUBER_BACKEND=exact",
])
def test_durability_knobs_and_the_exact_backend_boot_and_serve(knob, tmp_path):
    """The managers and the exact backend are ported: a Server built with
    the knob boots, builds the manager (or the host backend), answers a key
    through its gRPC door until it is over the limit, and drains."""
    import asyncio

    from gubernator_tpu_torch.client import AsyncV1Client
    from gubernator_tpu_torch.serve.backends import ExactBackend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    g, h, dead = free_ports(3)
    key, _, value = knob.partition("=")
    value = value.replace("<tmp>", str(tmp_path / "ckpt")).replace("<dead>", str(dead))
    env = {"GUBER_GRPC_ADDRESS": f"127.0.0.1:{g}", "GUBER_HTTP_ADDRESS": f"127.0.0.1:{h}",
           "GUBER_STORE_MIB": "8", key: value}
    conf = config_from_env(env)

    async def run():
        server = Server(conf, device="cpu")
        inst = server.instance
        manager = {
            "GUBER_REPLICATION": inst.repl, "GUBER_RESCALE": inst.rescale,
            "GUBER_CHECKPOINT_DIR": inst.checkpoint,
            "GUBER_CHECKPOINT_EXPORT_PEERS": inst.checkpoint,
        }.get(key, inst.backend)
        assert manager is not None
        if key == "GUBER_BACKEND":
            assert isinstance(inst.backend, ExactBackend)
        await server.start()
        try:
            client = AsyncV1Client(f"127.0.0.1:{g}")
            try:
                req = RateLimitReq(name="boot", unique_key="k", hits=1, limit=2,
                                   duration=60_000)
                got = [(await client.get_rate_limits([req]))[0] for _ in range(3)]
            finally:
                await client.close()
            assert [(r.error, int(r.status), r.remaining) for r in got] == [
                ("", 0, 1), ("", 0, 0), ("", 1, 0)]
            timings = await server.drain()
            if key == "GUBER_CHECKPOINT_DIR":
                assert "checkpoint_flush" in timings
                assert (tmp_path / "ckpt" / "manifest.json").exists()
        finally:
            await server.stop()

    asyncio.run(run())
