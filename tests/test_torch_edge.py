"""The port's copy of the compiled edge (native/edge/, built by
`gubernator_tpu_torch.native.edge_build`) in front of the port's CPU
server and in front of the JAX package's, on the CPU.

The edge is built once for the module from the port's own sources. A
one-node port cluster (`TorchBackend(device="cpu")`) and a one-node JAX
cluster (`TpuBackend`, the small store and rungs of
tests/test_functional.py) are booted in turn on the same free ports,
each with its edge bridge on a unix socket, under one pinned clock; the
edge runs in front of each and the same script drives its HTTP JSON door
and its gRPC door (the cases of tests/test_edge.py, tests/test_edge_grpc.py
and tests/test_edge_fast_path.py). The answers must be identical.

The differential runs on both slot hashes, both packages pinned to the
same one (tests/test_torch_hash.py). On the port's native XXH64 (its default
where g++ builds it) the edge's eligible items ride fast frames, hashed
by the edge: edge_fast_items_total rises. On blake2b-8 the port's bridge
withholds fast frames from the XXH64-hashing edge (serve/edge_bridge.py),
so the items ride string frames that the string fold serves on the array
path: edge_folded_items_total rises and edge_fast_items_total does not.
The hash-agreement pin, on each hash: one key through the edge and
through the port's GEB fast client shares one count.
"""

import asyncio
import json
import os
import socket
import subprocess
import tempfile
import time
import urllib.error
import urllib.request

import grpc
import pytest

import gubernator_tpu.api.types as j_types
import gubernator_tpu.core.engine as j_engine
import gubernator_tpu.serve.edge_bridge as jeb
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.serve.edge_bridge as teb
from test_torch_hash import HASHES, pin_hash
from _util import free_ports
from gubernator_tpu.cluster import LocalCluster as JLocalCluster
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.serve.backends import TpuBackend
from gubernator_tpu_torch.api.grpc_glue import V1Stub
from gubernator_tpu_torch.api.proto.gen import gubernator_pb2
from gubernator_tpu_torch.client_geb import GebClient
from gubernator_tpu_torch.cluster import LocalCluster
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.native import edge_build
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.backends import TorchBackend

T0 = 1_700_000_000_000
BUCKETS = (64, 256, 1024)


class FakeClock:
    def __init__(self):
        self.t = T0

    def __call__(self) -> int:
        return self.t


def _torch_backend():
    return TorchBackend(StoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS, device="cpu")


def _jax_backend():
    return TpuBackend(JStoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS)


@pytest.fixture(scope="module")
def edge_bin():
    return edge_build.build()


def _wait_port(port, proc, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            pytest.fail(f"edge died:\n{proc.stdout.read()}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    pytest.fail(f"edge never listened on {port}")


def _post(port, body, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/GetRateLimits",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _pb(key, hits=1, limit=5, **kw):
    return gubernator_pb2.RateLimitReq(name="ge", unique_key=key, hits=hits, limit=limit,
                                       duration=60_000, **kw)


def _grpc_rows(resp):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))
            for r in resp.responses]


def _script(http_port, grpc_port, clock):
    """The requests both stacks take through the edge, in order."""
    out = {}
    walk = {"name": "e", "uniqueKey": "k1", "hits": 1, "limit": 3, "duration": 60000}
    out["json_walk"] = [_post(http_port, {"requests": [walk]}) for _ in range(4)]
    out["json_gateway_shapes"] = _post(http_port, {"requests": [
        {"name": "e", "uniqueKey": "k2", "hits": "2", "limit": "5", "duration": "60000",
         "algorithm": "LEAKY_BUCKET"},
        {"name": "e", "uniqueKey": "k3", "hits": 1, "limit": 4, "duration": 1000,
         "algorithm": "GCRA"},
        {"name": "e", "uniqueKey": "k4", "hits": 1, "limit": 4, "duration": 1000,
         "algorithm": "SLIDING_WINDOW"},
        {"name": "e", "uniqueKey": "k2", "hits": 1, "limit": 5, "duration": 60000,
         "algorithm": 1}]})
    out["json_validation"] = _post(http_port, {"requests": [
        {"name": "", "uniqueKey": "x", "hits": 1, "limit": 1, "duration": 1000},
        {"name": "e", "uniqueKey": "", "hits": 1, "limit": 1, "duration": 1000},
        {"name": "e", "uniqueKey": "ok", "hits": 1, "limit": 1, "duration": 1000}]})
    out["json_malformed"] = _post(http_port, None, raw=b"{not json")
    with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/v1/HealthCheck",
                                timeout=10) as r:
        out["json_health"] = json.loads(r.read())["status"]
    clock.t += 1500  # the 1 s windows reset
    out["json_after_reset"] = _post(http_port, {"requests": [
        {"name": "e", "uniqueKey": "k3", "hits": 1, "limit": 4, "duration": 1000,
         "algorithm": "GCRA"}]})
    chan = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
    try:
        v1 = V1Stub(chan)
        rl = lambda reqs: _grpc_rows(v1.GetRateLimits(  # noqa: E731
            gubernator_pb2.GetRateLimitsReq(requests=reqs), timeout=20))
        out["grpc_walk"] = [rl([_pb("g1", limit=3)]) for _ in range(4)]
        out["grpc_shared_with_json"] = rl([gubernator_pb2.RateLimitReq(
            name="e", unique_key="k1", hits=0, limit=3, duration=60_000)])
        out["grpc_batch"] = rl([_pb(f"b{i % 5}", hits=i % 3, limit=4, algorithm=i % 4)
                                for i in range(40)])
        out["grpc_validation"] = rl([_pb("", limit=1), _pb("v", limit=1),
                                     gubernator_pb2.RateLimitReq(unique_key="n", hits=1,
                                                                 limit=1, duration=1000)])
        out["grpc_global_and_no_batching"] = rl([_pb("gl", behavior=2), _pb("nb", behavior=1),
                                                 _pb("gl", behavior=2)])
        out["grpc_health"] = v1.HealthCheck(gubernator_pb2.HealthCheckReq(), timeout=10).status
    finally:
        chan.close()
    return out


def _drive(name, ports, clock, edge_bin):
    g, h, geb, eh, eg = ports
    cls, factory, pkg = ((LocalCluster, _torch_backend, teb) if name == "torch"
                         else (JLocalCluster, _jax_backend, jeb))
    sock = os.path.join(tempfile.mkdtemp(), "e.sock")
    c = cls([f"127.0.0.1:{g}"], backend_factory=factory, http_addresses=[f"127.0.0.1:{h}"],
            geb_ports=[geb])
    c.start()
    out = {}
    try:
        c.servers[0].instance.shed.now_fn = clock

        async def bridge_up():
            b = pkg.EdgeBridge(c.servers[0].instance, sock)
            await b.start()
            return b

        bridge = c.run(bridge_up())
        edge = subprocess.Popen(
            [str(edge_bin), "--listen", str(eh), "--grpc-listen", str(eg), "--backend", sock,
             "--workers", "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            _wait_port(eh, edge)
            _wait_port(eg, edge)
            fast0 = metrics.EDGE_FAST_ITEMS._value.get()
            folded0 = metrics.EDGE_FOLDED_ITEMS._value.get()
            out = _script(eh, eg, clock)
            out["port_counters"] = (metrics.EDGE_FAST_ITEMS._value.get() - fast0,
                                    metrics.EDGE_FOLDED_ITEMS._value.get() - folded0)
            if name == "torch":
                out["shared_count"] = _shared_count(eh, geb)
                out["hash_parity_wide"] = _hash_parity_wide(eg, geb)
        finally:
            edge.terminate()
            edge.wait(timeout=10)
            c.run(bridge.stop())
    finally:
        c.stop()
    return out


def _shared_count(edge_http, geb_port):
    """Alternate hits on one key between the edge (string frames, hashed
    in the server) and the GEB door's fast frames (hashed by the client):
    one count, or each door would start the key fresh."""
    seen = []
    with GebClient(f"127.0.0.1:{geb_port}", mode="fast", timeout=20) as cl:
        assert cl.stats()["use_fast"] or cl.connect().fast
        for i in range(6):
            if i % 2 == 0:
                _, body = _post(edge_http, {"requests": [
                    {"name": "share", "uniqueKey": "one", "hits": 1, "limit": 10,
                     "duration": 60000}]})
                seen.append(int(body["responses"][0]["remaining"]))
            else:
                r = cl.get_rate_limits([t_types.RateLimitReq(
                    name="share", unique_key="one", hits=1, limit=10, duration=60_000)])
                seen.append(r[0].remaining)
        assert cl.stats()["use_fast"]
    return seen


def _hash_parity_wide(edge_grpc, geb_port):
    """64 keys (utf-8 among them) through the edge's gRPC door (pre-hashed
    by the edge when fast frames are offered), then each read through
    the GEB door's string frames (hashed in the server): any hash
    mismatch shows as a key whose hit the read does not see
    (tests/test_edge_fast_path.py::test_hash_parity_wide)."""
    keys = [f"wide-{i}-é{i % 7}" for i in range(64)]
    with grpc.insecure_channel(f"127.0.0.1:{edge_grpc}") as chan:
        r = V1Stub(chan).GetRateLimits(gubernator_pb2.GetRateLimitsReq(
            requests=[_pb(k, limit=9) for k in keys]), timeout=20)
    first = [x.remaining for x in r.responses]
    with GebClient(f"127.0.0.1:{geb_port}", mode="string", timeout=20) as cl:
        read = [x.remaining for x in cl.get_rate_limits([t_types.RateLimitReq(
            name="ge", unique_key=k, hits=0, limit=9, duration=60_000) for k in keys])]
    return first, read


_RUNS: dict = {}


@pytest.fixture(scope="module", params=HASHES)
def runs(edge_bin, request):
    # tests parametrised on one hash set the fixture up again: drive the
    # two packages once a hash all the same
    if request.param in _RUNS:
        return _RUNS[request.param]
    results = {"hash": request.param}
    ports = free_ports(5)
    with pytest.MonkeyPatch.context() as mp:
        pin_hash(mp, request.param)
        clock = FakeClock()
        mp.setattr(j_types, "millisecond_now", clock)
        mp.setattr(j_engine, "millisecond_now", clock, raising=False)
        mp.setattr(t_types, "millisecond_now", clock)
        for name in ("torch", "jax"):
            clock.t = T0
            results[name] = _drive(name, ports, clock, edge_bin)
    _RUNS[request.param] = results
    return results


def test_edge_builds_from_the_ports_sources_into_build(edge_bin):
    assert edge_bin.parent == edge_build.BUILD_DIR and os.access(edge_bin, os.X_OK)
    assert edge_build.SOURCE_DIR.parent.parent.name == "gubernator_tpu_torch"
    assert edge_build.build() == edge_bin  # up to date: no second build
    ref = edge_build._PKG.parent / "gubernator_tpu" / "native" / "edge"
    # a byte-for-byte copy, but for the logs of a wait or a socket call
    # over a second: the reference's two waits became wait_logged calls,
    # the accept loops' accept and the client connections' reads and
    # writes call_logged calls (the gRPC reads through recv_all, which
    # now says whether part of the frame has arrived), and nothing else
    # of it went
    import difflib

    went = {
        "edge.cc": [
            "st->cv.wait(lk, [&] {", "return st->dead || st->inflight.size() < window;",
            "});", "p.cv.wait(lk, [&p] { return p.shards_left == 0; });",
            "ssize_t w = write(fd, out.data() + off, out.size() - off);",
            "ssize_t r = read(fd, tmp, sizeof tmp);", "ssize_t r = read(fd, tmp, sizeof tmp);",
            "int fd = accept(lsrv, nullptr, nullptr);",
        ],
        "h2_grpc.inc": [
            "ssize_t w = write(c->fd, p, n);", "auto recv_all = [&](char* p, size_t n) {",
            "ssize_t r = read(fd, p, n);",
            "if (!recv_all(preface, 24) || memcmp(preface, kPreface, 24) != 0) {",
            "if (!recv_all((char*)hdr, 9)) break;",
            "if (len && !recv_all(payload.data(), len)) break;",
        ],
    }
    for name in edge_build.SOURCES:
        ours, theirs = (edge_build.SOURCE_DIR / name).read_text(), (ref / name).read_text()
        if name not in went:
            assert ours == theirs, name
            continue
        removed = [ln[1:].strip() for ln in difflib.unified_diff(
            theirs.splitlines(), ours.splitlines(), lineterm="", n=0)
            if ln.startswith("-") and not ln.startswith("---")]
        assert removed == went[name], name
    cc = (edge_build.SOURCE_DIR / "edge.cc").read_text()
    inc = (edge_build.SOURCE_DIR / "h2_grpc.inc").read_text()
    assert cc.count("wait_logged(") == 3  # its definition and the two waits
    # its definition, the http write, two reads and the accept
    assert cc.count("call_logged(") == 5 and inc.count("call_logged(") == 2


def test_failed_edge_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(edge_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(edge_build, "CXX_FLAGS", ("-O2", "-DFORCE_FAIL", "-include",
                                                   "/nonexistent/header.h"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        edge_build.build()
    # no half-written binary left (the build's lock file stays, as it does
    # beside every output)
    assert [p.suffix for p in tmp_path.iterdir()] == [".lock"]


CASES = ["json_walk", "json_gateway_shapes", "json_validation", "json_malformed",
         "json_health", "json_after_reset", "grpc_walk", "grpc_shared_with_json",
         "grpc_batch", "grpc_validation", "grpc_global_and_no_batching", "grpc_health"]


@pytest.mark.parametrize("case", CASES)
def test_edge_answers_match_jax(runs, case):
    assert runs["torch"][case] == runs["jax"][case]


def test_edge_walks_and_errors_on_the_port(runs):
    t = runs["torch"]
    assert [b["responses"][0]["remaining"] for _, b in t["json_walk"]] == ["2", "1", "0", "0"]
    assert t["json_walk"][3][1]["responses"][0]["status"] == "OVER_LIMIT"
    assert len({b["responses"][0]["resetTime"] for _, b in t["json_walk"]}) == 1
    assert t["json_malformed"] == (400, None)
    assert t["json_validation"][1]["responses"][0]["error"] != ""
    assert [r[2] for r in sum(t["grpc_walk"], [])] == [2, 1, 0, 0]
    assert t["grpc_shared_with_json"][0][2] == 0  # the JSON walk's key
    assert t["json_health"] == "healthy" and t["grpc_health"] == "healthy"


@pytest.mark.parametrize("runs", ["blake2b"], indirect=True)
def test_edge_items_are_folded_never_fast_on_the_port(runs):
    """On a blake2b-8 store the edge's XXH64 items are folded, never fast."""
    fast, folded = runs["torch"]["port_counters"]
    assert fast == 0 and folded > 0


@pytest.mark.parametrize("runs", ["xxh64"], indirect=True)
def test_edge_items_ride_fast_frames_on_xxh64(runs):
    """On an XXH64 store every edge item rides a fast frame: none folded."""
    fast, folded = runs["torch"]["port_counters"]
    assert fast > 0 and folded == 0


def test_edge_and_geb_fast_door_share_one_count(runs):
    assert runs["torch"]["shared_count"] == [9, 8, 7, 6, 5, 4]


def test_edge_hash_parity_wide(runs):
    first, read = runs["torch"]["hash_parity_wide"]
    assert first == [8] * 64 and read == [8] * 64


@pytest.mark.parametrize("slot_hash", HASHES)
def test_edge_bridge_hello_withholds_fast_from_the_edge(slot_hash, monkeypatch):
    """Withheld on a blake2b-8 store; offered, with HELLO_XXH64, on XXH64."""
    pin_hash(monkeypatch, slot_hash)

    class Inst:
        class backend:
            decide_submit_arrays = decide_submit = object()

    async def hello(path):
        b = teb.EdgeBridge(Inst(), path)
        await b.start()
        try:
            reader, writer = await asyncio.open_unix_connection(path)
            head = await reader.readexactly(16)
            writer.close()
            return head
        finally:
            await b.stop()

    head = asyncio.run(hello(os.path.join(tempfile.mkdtemp(), "h.sock")))
    flags = int.from_bytes(head[4:8], "little")
    xxh64 = slot_hash == "xxh64"
    assert flags & teb.HELLO_WINDOWED
    assert bool(flags & teb.HELLO_FAST) == bool(flags & teb.HELLO_XXH64) == xxh64


def test_edge_names_a_wait_over_one_second(edge_bin, tmp_path):
    """A bridge that says hello (windowed, a credit window of one frame)
    and then never answers: the edge's first request waits on its shard
    and the second on the lane's credit gate; each wait names itself on
    stderr once it has lasted a second, with the lane's state."""
    import struct
    import threading

    sock_path = str(tmp_path / "bridge.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    conns = []

    def serve():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            conns.append(c)
            c.sendall(struct.pack("<IIII", 0x49424547, 2 | (1 << 16), 0, 0))

    threading.Thread(target=serve, daemon=True).start()
    eh, eg = free_ports(2)
    edge = subprocess.Popen(
        [str(edge_bin), "--listen", str(eh), "--grpc-listen", str(eg), "--backend",
         sock_path, "--workers", "1"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _wait_port(eh, edge)
        body = {"requests": [{"name": "w", "uniqueKey": "k", "hits": 1, "limit": 5,
                              "duration": 60000}]}
        def call():
            try:
                _post(eh, body)
            except OSError:  # the edge is killed with the call in flight
                pass

        callers = [threading.Thread(target=call, daemon=True) for _ in range(2)]
        for t in callers:
            t.start()
            time.sleep(0.2)
        time.sleep(2.0)
    finally:
        edge.kill()
        err = edge.communicate(timeout=10)[1]
        srv.close()
        for c in conns:
            c.close()
    lines = [ln for ln in err.splitlines() if ln.startswith("guber-edge: wait '")]
    shards = [ln for ln in lines if "wait 'shards' over 1 s: 1 of 1 shards open" in ln]
    credit = [ln for ln in lines if "wait 'credit' over 1 s" in ln]
    assert len(shards) == 2 and len(credit) == 1, err
    assert f"lane {sock_path} " in credit[0] and "inflight=1 window=1" in credit[0], err
    assert "workers_busy=1" in shards[-1], err


def test_edge_names_a_socket_call_over_one_second(edge_bin, tmp_path):
    """A connection thread's read that returns after more than a second
    once part of a request has arrived names itself on stderr once it
    returns ("call '<name>' over 1 s: <ms> ms on fd ..."): a client that
    sends half a request and the rest 1.3 s later still gets its answer,
    and that read is the one line. Quiet peers log nothing: a listener
    idle for 1.3 s, a connection idle 1.3 s before its first request and
    again between keep-alive requests, and a gRPC connection idle 1.3 s
    before its preface and after it."""
    import struct
    import threading

    sock_path = str(tmp_path / "bridge.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    conns = []

    def serve():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            conns.append(c)
            c.sendall(struct.pack("<IIII", 0x49424547, 2 | (1 << 16), 0, 0))

    threading.Thread(target=serve, daemon=True).start()
    eh, eg = free_ports(2)
    edge = subprocess.Popen(
        [str(edge_bin), "--listen", str(eh), "--grpc-listen", str(eg), "--backend",
         sock_path, "--workers", "1"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    health = b"GET /v1/HealthCheck HTTP/1.1\r\nHost: x\r\n\r\n"
    replies = []
    try:
        _wait_port(eh, edge)
        _wait_port(eg, edge)
        time.sleep(1.3)  # idle listeners
        with socket.create_connection(("127.0.0.1", eh), timeout=10) as c, \
                socket.create_connection(("127.0.0.1", eg), timeout=10) as g:
            time.sleep(1.3)  # both connections idle before their first bytes
            g.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
            c.sendall(health)
            replies.append(c.recv(4096))
            time.sleep(1.3)  # an idle keep-alive, and gRPC idle after its preface
            c.sendall(health[:-2])
            time.sleep(1.3)  # half a request: this read is the one named
            c.sendall(b"\r\n")
            replies.append(c.recv(4096))
    finally:
        edge.kill()
        err = edge.communicate(timeout=10)[1]
        srv.close()
        for c in conns:
            c.close()
    assert all(r.startswith(b"HTTP/1.1 200") for r in replies), replies
    calls = [ln for ln in err.splitlines() if ln.startswith("guber-edge: call '")]
    reads = [ln for ln in calls if ln.startswith("guber-edge: call 'http read' over 1 s: ")]
    assert len(calls) == 1 and len(reads) == 1, err
    ms = int(reads[0].split("over 1 s: ")[1].split(" ms")[0])
    assert 1000 < ms < 10_000 and ", rc " in reads[0] and ", errno 0" in reads[0], err
    # no wait was logged: the lanes were idle
    assert not [ln for ln in err.splitlines() if ln.startswith("guber-edge: wait '")], err
