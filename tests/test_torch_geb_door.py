"""The port's GEB frame doors against the JAX package's, on the CPU.

A one-node port cluster (`TorchBackend(device="cpu")`) and a one-node JAX
cluster (`TpuBackend`, the small store and rungs of
tests/test_functional.py) are booted in turn on the same free ports, each
with its GEB door (GUBER_GEB_PORT) and its HTTP gateway, under one pinned
clock, and driven by the same script:

- the same seeded frames through the GEB socket door and through
  POST /v1/geb: legacy and windowed string frames (GEB1, GEB2), legacy and
  windowed fast frames (GEB6, GEB7), traced frames (GEBT), all four
  algorithms, duplicate keys and peeks. The response bytes must be
  identical, and so must the store bytes after;
- the port's `GebClient` (fast, string and auto) and the JAX
  `gubernator_tpu.client_geb.GebClient` against each door: the wire is
  the same, so the JAX client must work against the port's door, with
  identical answers;
- a stale-ring fast frame (GEBR with the frame's id, then the connection
  closes) and a drain (GEBR with the drain code on a connection opened
  before it);
- a chained item (GEBC): the port answers it with its per-item
  "not ported" error and serves the frame's plain items as the JAX door
  does; its hello withholds HELLO_CHAIN, so the port's client refuses a
  chained batch before the wire.

The fast frames need both packages to hash with one slot hash; both are
pinned to blake2b-8 (tests/test_torch_hash.py), which the JAX client hashes
with where the JAX package's native library is not built. Cases of
tests/test_geb_client.py, tests/test_geb_differential.py and
tests/test_bridge_robustness.py. Tolerance is zero.
"""

import asyncio
import json
import socket
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

import gubernator_tpu.api.types as j_types
import gubernator_tpu.client_geb as jclient
import gubernator_tpu.core.engine as j_engine
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.client_geb as tclient
from test_torch_hash import pin_hash
from _util import free_ports
from gubernator_tpu.cluster import LocalCluster as JLocalCluster
from gubernator_tpu.core.store import StoreConfig as JStoreConfig
from gubernator_tpu.serve.backends import TpuBackend
from gubernator_tpu_torch.cluster import LocalCluster
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import TorchBackend
from gubernator_tpu_torch.serve.instance import CHAINS_NOT_PORTED
from gubernator_tpu_torch.serve.tracing import TraceContext

T0 = 1_700_000_000_000
BUCKETS = (64, 256, 1024)  # tests/test_functional.py:34-37
CT = tclient.GEB_CONTENT_TYPE


class FakeClock:
    def __init__(self):
        self.t = T0

    def __call__(self) -> int:
        return self.t


def _torch_backend():
    return TorchBackend(StoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS, device="cpu")


def _jax_backend():
    return TpuBackend(JStoreConfig(rows=4, slots=1 << 12), buckets=BUCKETS)


def _requests(rng, n, fast_only, types=t_types):
    reqs = []
    for _ in range(n):
        k = int(rng.integers(0, 12))  # few keys: duplicates within a frame
        reqs.append(types.RateLimitReq(
            name="geb", unique_key=f"key{k}", hits=int(rng.choice([0, 1, 1, 2])),
            limit=int(rng.choice([2, 3, 50])), duration=int(rng.choice([1000, 60_000])),
            algorithm=types.Algorithm(k % 4),
            behavior=(types.Behavior.BATCHING if fast_only or rng.random() < 0.7
                      else types.Behavior.NO_BATCHING)))
    return reqs


#: (name, door, framing) of each scripted step, in order
STEPS = [
    ("sock_geb7_fast", "sock", "geb7"), ("sock_geb2_string", "sock", "geb2"),
    ("sock_gebt_traced", "sock", "gebt"), ("sock_geb1_legacy", "sock", "geb1"),
    ("sock_geb6_legacy_fast", "sock", "geb6"), ("http_geb7_fast", "http", "geb7"),
    ("http_geb2_string", "http", "geb2"), ("http_gebt_traced", "http", "gebt"),
    ("http_geb1_legacy", "http", "geb1"), ("sock_geb7_fast_again", "sock", "geb7"),
]


def _frame(framing, reqs, ring, fid):
    windowed = framing in ("geb7", "geb2", "gebt")
    fast = framing in ("geb7", "geb6")
    ctx = TraceContext(0x1234, 0x99, True) if framing == "gebt" else None
    frame, is_fast = tclient.build_frame(reqs, fast=fast, windowed=windowed,
                                         frame_id=fid, ring_hash=ring, trace_ctx=ctx)
    assert is_fast == fast
    return frame


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(f"closed after {len(buf)} of {n} bytes")
        buf += chunk
    return buf


def _read_response(sock) -> bytes:
    """One whole response frame off a GEB socket, as bytes."""
    hdr = _recv(sock, 8)
    magic, n = struct.unpack("<II", hdr)
    if magic == tclient.MAGIC_STALE:
        return hdr
    out = hdr
    if magic in (tclient.MAGIC_WRESP, tclient.MAGIC_WFAST_RESP):
        out += _recv(sock, 4)
    if magic in (tclient.MAGIC_FAST_RESP, tclient.MAGIC_WFAST_RESP):
        return out + _recv(sock, 25 * n)
    for _ in range(n):
        out += _recv(sock, 25)
        for _field in range(2):  # error, owner
            ln = _recv(sock, 2)
            out += ln + _recv(sock, struct.unpack("<H", ln)[0])
    return out


class GebSocket:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=20)
        head = _recv(self.sock, 16)
        n_nodes = struct.unpack_from("<I", head, 12)[0]
        rest = b""
        for _ in range(n_nodes):
            fix = _recv(self.sock, 3)
            g = _recv(self.sock, struct.unpack_from("<H", fix, 1)[0])
            bl = _recv(self.sock, 2)
            rest += fix + g + bl + _recv(self.sock, struct.unpack("<H", bl)[0])
        self.hello = head + rest
        self.ring = struct.unpack_from("<I", head, 8)[0]

    def exchange(self, frame: bytes) -> bytes:
        self.sock.sendall(frame)
        return _read_response(self.sock)

    def closed(self) -> bool:
        self.sock.settimeout(5)
        try:
            return self.sock.recv(1) == b""
        except ConnectionError:
            return True

    def close(self):
        self.sock.close()


def _post(base, body: bytes, ctype=CT):
    req = urllib.request.Request(base + "/v1/geb", data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=20) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"].split(":")[0]


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=20) as r:
        return r.read()


def _resps(rs):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))
            for r in rs]


def _store_bytes(backend):
    data = backend.engine.store.data
    return data.numpy().tobytes() if hasattr(data, "numpy") else np.asarray(data).tobytes()


def _drive(name, ports, clock):
    g, h, geb = ports
    cls, factory, types, client = (
        (LocalCluster, _torch_backend, t_types, tclient) if name == "torch"
        else (JLocalCluster, _jax_backend, j_types, jclient))
    c = cls([f"127.0.0.1:{g}"], backend_factory=factory,
            http_addresses=[f"127.0.0.1:{h}"], geb_ports=[geb])
    c.start()
    out = {}
    base = f"http://127.0.0.1:{h}"
    try:
        srv = c.servers[0]
        srv.instance.shed.now_fn = clock
        s = GebSocket(geb)
        out["hello_socket"] = s.hello
        out["hello_http"] = _get(base, "/v1/geb")
        rng = np.random.default_rng(5)
        for i, (step, door, framing) in enumerate(STEPS):
            reqs = _requests(rng, int(rng.integers(1, 40)), framing in ("geb7", "geb6"))
            frame = _frame(framing, reqs, s.ring, fid=100 + i)
            out[step] = s.exchange(frame) if door == "sock" else _post(base, frame)
            clock.t += int(rng.choice([0, 7, 400, 1500]))
        # the packaged clients, each mode, the port's and the JAX one
        for cname, mod in (("torch_client", tclient), ("jax_client", jclient)):
            for mode in ("fast", "string", "auto"):
                reqs = _requests(rng, 30, fast_only=mode != "string", types=(
                    t_types if mod is tclient else j_types))
                with mod.GebClient(f"127.0.0.1:{geb}", mode=mode, timeout=20) as cl:
                    got = cl.get_rate_limits(reqs)
                    out[f"{cname}_{mode}"] = (_resps(got), cl.stats()["use_fast"])
                clock.t += 300
        async def http_run():
            http_cl = tclient.AsyncHttpGebClient(base)
            try:
                return _resps(await http_cl.get_rate_limits(_requests(rng, 20, True))), True
            finally:
                await http_cl.close()

        out["torch_http_client"] = asyncio.run(http_run())
        out["wrong_content_type"] = _post(base, b"{}", ctype="application/json")
        out["garbage_frame"] = _post(base, b"\x01\x02\x03\x04\x05\x06\x07\x08\x09")
        out["store"] = _store_bytes(srv.backend)
        # a stale-ring fast frame: GEBR with the frame's id, then closed
        stale = _frame("geb7", _requests(rng, 3, True), s.ring ^ 1, fid=555)
        out["stale_ring"] = (s.exchange(stale), s.closed())
        s.close()
        # chained items: the port's per-item refusal (after the store
        # snapshot: the JAX door serves chains, and debits their levels)
        chain = [types.RateLimitReq(name="c", unique_key="plain", hits=1, limit=5, duration=60_000),
                 types.RateLimitReq(name="c", unique_key="leaf", hits=1, limit=5, duration=60_000,
                                    chain=[types.ChainLevel(unique_key="head", limit=9,
                                                            duration=60_000)])]
        s = GebSocket(geb)
        cframe = tclient.build_frame(chain, fast=False, windowed=True, frame_id=7)[0]
        out["chain_frame"] = tclient.decode_string_body(s.exchange(cframe)[12:], 2)
        try:
            with client.GebClient(f"127.0.0.1:{geb}", mode="string", timeout=20) as cl:
                out["chain_client"] = _resps(cl.get_rate_limits(chain))
        except client.GebError as e:
            out["chain_client"] = type(e).__name__
        # drain: frames on a connection opened before it are refused
        # with the drain code, and the door closes
        c.run(srv.drain())
        out["drain"] = (s.exchange(_frame("geb7", _requests(rng, 2, True), s.ring, 9)),
                        s.closed())
        s.close()
    finally:
        c.stop()
    return out


@pytest.fixture(scope="module")
def runs():
    results = {}
    ports = free_ports(3)
    with pytest.MonkeyPatch.context() as mp:
        # the fast-frame identity needs both packages (and their clients)
        # on one slot hash: blake2b-8, which the JAX client hashes with here
        pin_hash(mp, "blake2b")
        clock = FakeClock()
        mp.setattr(j_types, "millisecond_now", clock)
        mp.setattr(j_engine, "millisecond_now", clock, raising=False)
        mp.setattr(t_types, "millisecond_now", clock)
        for name in ("torch", "jax"):
            clock.t = T0
            results[name] = _drive(name, ports, clock)
    return results


def _flags(hello: bytes) -> int:
    return struct.unpack_from("<I", hello, 4)[0]


@pytest.mark.parametrize("door", ["hello_socket", "hello_http"])
def test_hello_matches_jax_except_the_chain_bit(runs, door):
    t, j = runs["torch"][door], runs["jax"][door]
    assert t[:4] + t[8:] == j[:4] + j[8:]
    # bit 3 only: both doors offer fast (bit 0) to a blake2b client
    assert _flags(t) | tclient.HELLO_CHAIN == _flags(j)
    hello = tclient.parse_hello_bytes(t)
    assert hello.fast and hello.windowed and hello.trace
    assert not hello.xxh64 and not hello.chain and not hello.shm


@pytest.mark.parametrize("step", [s[0] for s in STEPS])
def test_frame_response_bytes_match_jax(runs, step):
    t, j = runs["torch"][step], runs["jax"][step]
    assert t == j
    body = t[1] if isinstance(t, tuple) else t
    if isinstance(t, tuple):
        assert t[0] == 200
    magic = struct.unpack_from("<I", body, 0)[0]
    assert magic != tclient.MAGIC_STALE


@pytest.mark.parametrize("client", [f"{c}_{m}" for c in ("torch_client", "jax_client")
                                    for m in ("fast", "string", "auto")]
                         + ["torch_http_client"])
def test_packaged_clients_match_jax(runs, client):
    t, j = runs["torch"][client], runs["jax"][client]
    assert t == j
    if client.endswith(("_fast", "_auto", "_http_client")):
        assert t[1] is True  # fast framing negotiated against the port
    if client.endswith("_string"):
        assert t[1] is False


def test_store_bytes_match_jax_after_the_frames(runs):
    assert runs["torch"]["store"] == runs["jax"]["store"]
    assert any(runs["torch"]["store"])


def test_http_door_refusals_match_jax(runs):
    for case in ("wrong_content_type", "garbage_frame"):
        assert runs["torch"][case] == runs["jax"][case]
    assert runs["torch"]["wrong_content_type"][0] == 415
    assert runs["torch"]["garbage_frame"] == (400, "bad GEB frame")


def test_stale_ring_fast_frame_is_refused_and_closed(runs):
    assert runs["torch"]["stale_ring"] == runs["jax"]["stale_ring"]
    assert runs["torch"]["stale_ring"] == (struct.pack("<II", tclient.MAGIC_STALE, 555), True)


def test_drain_refuses_with_the_drain_code(runs):
    assert runs["torch"]["drain"] == runs["jax"]["drain"]
    assert runs["torch"]["drain"] == (
        struct.pack("<II", tclient.MAGIC_STALE, tclient.DRAIN_FRAME_ID), True)


def test_chained_items_get_the_ports_per_item_answer(runs):
    t, j = runs["torch"]["chain_frame"], runs["jax"]["chain_frame"]
    assert _resps(t[:1]) == _resps(j[:1])  # the plain item, served alike
    assert t[1].error == CHAINS_NOT_PORTED and t[1].limit == 0
    assert j[1].error == ""  # the reference serves the chain
    # no HELLO_CHAIN on the port: its client refuses before the wire
    assert runs["torch"]["chain_client"] == "GebError"
    assert runs["jax"]["chain_client"][1][4] == ""
