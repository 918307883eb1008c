"""The port's GEB frame codecs, hello and frame core against the JAX
package's, on the CPU.

The same seeded inputs (numpy) go through `gubernator_tpu.serve.edge_bridge`
and `gubernator_tpu_torch.serve.edge_bridge`:

- the decoders (`decode_request_frame`, `decode_chain_request_frame`),
  `encode_response_frame`, `ring_fingerprint`, `bound_payload_len` and the
  fast-record dtypes must agree exactly (tolerance zero);
- the hello must be byte-identical, on both slot hashes (both packages
  pinned to blake2b-8 or to the port's native XXH64, tests/test_torch_hash.py),
  except in HELLO_CHAIN (bit 3), which the port never sets because quota
  chains are not ported, and, on blake2b-8 only, HELLO_FAST (bit 0) on
  the edge bridge, which withholds it there because the compiled edge
  pre-hashes XXH64;
- malformed frames (a seeded hostile corpus, and a hypothesis fuzz) close
  the connection in both packages, and a listener survives them.

Frame cores run over a fake instance (the cases of
tests/test_geb_listener.py and the codec cases of tests/test_edge_bridge.py);
the real serving path is tests/test_torch_geb_door.py's.
"""

import asyncio
import os
import struct
import tempfile
from dataclasses import dataclass

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gubernator_tpu.serve.edge_bridge as jeb
import gubernator_tpu_torch.client_geb as tclient
import gubernator_tpu_torch.serve.edge_bridge as teb
import gubernator_tpu_torch.serve.shm as tshm
from test_torch_hash import HASHES, pin_hash
from _util import free_ports
from gubernator_tpu.api.types import RateLimitResp as JResp
from gubernator_tpu.api.types import Status as JStatus
from gubernator_tpu_torch.api.types import RateLimitResp as TResp
from gubernator_tpu_torch.api.types import Status as TStatus

PKGS = {
    "jax": (jeb, JResp, JStatus),
    "torch": (teb, TResp, TStatus),
}

#: the hello bit the port never sets (module docstring)
PORT_HELLO_BITS = teb.HELLO_CHAIN


def _item(name: bytes, key: bytes, hits=1, limit=5, duration=1000,
          algo=0, behavior=0) -> bytes:
    return (
        struct.pack("<H", len(name)) + name
        + struct.pack("<H", len(key)) + key
        + struct.pack("<qqqBB", hits, limit, duration, algo, behavior)
    )


def _chain_item(name, key, levels, **kw) -> bytes:
    out = _item(name, key, **kw) + struct.pack("<B", len(levels))
    for lk, li, d in levels:
        out += struct.pack("<H", len(lk)) + lk + struct.pack("<qq", li, d)
    return out


def _rand_bytes(rng, lo, hi, bad_share=0.1) -> bytes:
    if rng.random() < bad_share:
        return b"\xff\xfe" + rng.bytes(int(rng.integers(0, 4)))
    n = int(rng.integers(lo, hi))
    return bytes(rng.integers(97, 123, n).astype(np.uint8))


def _req_tuple(r):
    if r is None:
        return None
    return (r.name, r.unique_key, r.hits, r.limit, r.duration, int(r.algorithm),
            int(r.behavior), [(c.unique_key, c.limit, c.duration) for c in r.chain])


# -- wire constants ---------------------------------------------------------

CONSTANTS = [
    "MAGIC_REQ", "MAGIC_RESP", "MAGIC_HELLO", "MAGIC_FAST_REQ", "MAGIC_FAST_RESP",
    "MAGIC_STALE", "MAGIC_WREQ", "MAGIC_WRESP", "MAGIC_WFAST_REQ", "MAGIC_WFAST_RESP",
    "MAGIC_WTRACE", "MAGIC_WCHAIN", "MAGIC_SHM_REQ", "MAGIC_SHM_OK", "HELLO_FAST",
    "HELLO_WINDOWED", "HELLO_XXH64", "HELLO_CHAIN", "HELLO_TRACE", "HELLO_SHM",
    "DRAIN_FRAME_ID", "MAX_FRAME_PAYLOAD", "EDGE_MAX_FRAME_PAYLOAD",
    "DEFAULT_WINDOW", "MAX_WINDOW",
]


@pytest.mark.parametrize("name", CONSTANTS)
def test_wire_constant_matches_jax_and_the_client(name):
    assert getattr(teb, name) == getattr(jeb, name)
    if hasattr(tclient, name):
        assert getattr(tclient, name) == getattr(teb, name)
    if hasattr(tshm, name):
        assert getattr(tshm, name) == getattr(teb, name)


def test_fast_and_string_response_dtypes_match_jax():
    assert teb._fast_dtypes() == jeb._fast_dtypes()
    assert teb._string_resp_dtype() == jeb._string_resp_dtype()
    req_dt, resp_dt = teb._fast_dtypes()
    assert (req_dt.itemsize, resp_dt.itemsize) == (33, 25)


# -- codecs -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_decode_request_frame_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    payload = b"".join(
        _item(_rand_bytes(rng, 0, 12), _rand_bytes(rng, 0, 20),
              hits=int(rng.integers(-3, 1 << 40)), limit=int(rng.integers(0, 1 << 40)),
              duration=int(rng.integers(0, 1 << 40)), algo=int(rng.integers(0, 6)),
              behavior=int(rng.integers(0, 5)))
        for _ in range(n)
    )
    t = [_req_tuple(r) for r in teb.decode_request_frame(payload, n)]
    j = [_req_tuple(r) for r in jeb.decode_request_frame(payload, n)]
    assert t == j
    assert any(r is None for r in t) or seed  # seed 0 draws a bad item
    with pytest.raises(ValueError):
        teb.decode_request_frame(payload + b"x", n)


@pytest.mark.parametrize("seed", range(3))
def test_decode_chain_request_frame_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 20))
    payload = b"".join(
        _chain_item(_rand_bytes(rng, 1, 8), _rand_bytes(rng, 1, 8),
                    [(_rand_bytes(rng, 1, 6), int(rng.integers(1, 99)),
                      int(rng.integers(1, 1 << 20))) for _ in range(int(rng.integers(0, 4)))],
                    limit=int(rng.integers(1, 99)))
        for _ in range(n)
    )
    t = [_req_tuple(r) for r in teb.decode_chain_request_frame(payload, n)]
    j = [_req_tuple(r) for r in jeb.decode_chain_request_frame(payload, n)]
    assert t == j
    with pytest.raises(ValueError):
        teb.decode_chain_request_frame(payload + b"\0", n)


@pytest.mark.parametrize("shape", ["plain", "errors_and_owners", "windowed"])
def test_encode_response_frame_matches_jax(shape):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(50):
        err = f"e{i}" if shape == "errors_and_owners" and i % 3 == 0 else ""
        owner = f"10.0.0.{i}:81" if shape == "errors_and_owners" and i % 4 == 1 else ""
        rows.append((int(rng.integers(0, 2)), int(rng.integers(0, 1 << 40)),
                     int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 42)), err, owner))

    def build(Resp, Status):
        return [Resp(status=Status(s), limit=li, remaining=rem, reset_time=rt, error=e,
                     metadata={"owner": o} if o else {})
                for s, li, rem, rt, e, o in rows]

    fid = 77 if shape == "windowed" else None
    magic = teb.MAGIC_WRESP if fid is not None else teb.MAGIC_RESP
    t = teb.encode_response_frame(build(TResp, TStatus), magic=magic, frame_id=fid)
    j = jeb.encode_response_frame(build(JResp, JStatus), magic=magic, frame_id=fid)
    assert t == j
    assert tclient.decode_string_body(t[12 if fid else 8:], 50)[3].remaining == rows[3][2]


def test_ring_fingerprint_and_payload_bound_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        hosts = [f"10.{int(rng.integers(256))}.0.{int(rng.integers(256))}:{int(rng.integers(1, 65535))}"
                 for _ in range(int(rng.integers(0, 8)))]
        assert teb.ring_fingerprint(hosts) == jeb.ring_fingerprint(hosts)
        assert teb.ring_fingerprint(hosts) == teb.ring_fingerprint(list(reversed(hosts)))
    for plen in (0, 1, teb.MAX_FRAME_PAYLOAD):
        assert teb.bound_payload_len(plen) == jeb.bound_payload_len(plen) == plen
    for pkg in (teb, jeb):
        with pytest.raises(ValueError):
            pkg.bound_payload_len(pkg.MAX_FRAME_PAYLOAD + 1)
        assert pkg.bound_payload_len(9 << 20, pkg.EDGE_MAX_FRAME_PAYLOAD) == 9 << 20


# -- hello ------------------------------------------------------------------


@dataclass
class FakePeer:
    host: str
    is_owner: bool = False


class _ArraysBackend:
    decide_submit_arrays = object()
    decide_submit = object()


class _Traffic:
    def observe_hashes(self, h):
        pass

    def observe(self, keys, hashes):
        pass


class _Picker:
    def __init__(self, peers):
        self._peers = peers

    def peers(self):
        return list(self._peers)


def _fake_instance(Resp, Status, peers=(), batcher=None):
    """Enough of an Instance for the frame core: a picker, an array
    backend, traffic sketches, an echoing object path and batcher."""

    class Batcher:
        sizes = []

        async def decide_arrays(self, fields, frame=True):
            n = fields["key_hash"].shape[0]
            Batcher.sizes.append(n)
            return (np.zeros(n, np.int64), fields["limit"], fields["limit"] - fields["hits"],
                    (fields["key_hash"] % np.uint64(1 << 40)).astype(np.int64))

    class Inst:
        backend = _ArraysBackend()
        picker = _Picker(list(peers))
        traffic = _Traffic()

        async def get_rate_limits(self, reqs, stage_frame=False):
            return [Resp(status=Status.UNDER_LIMIT, limit=r.limit,
                         remaining=max(r.limit - r.hits, 0), reset_time=5,
                         error="chained" if r.chain else "") for r in reqs]

    Inst.batcher = batcher or Batcher()
    return Inst()


PEERS = [FakePeer("10.0.0.2:81"), FakePeer("10.0.0.1:81", is_owner=True),
         FakePeer("10.0.0.3:81")]


@pytest.mark.parametrize("slot_hash", HASHES)
@pytest.mark.parametrize("door", ["geb", "geb_door_map", "core", "edge_unix", "edge_tcp"])
def test_hello_matches_jax_except_the_port_bits(door, slot_hash, monkeypatch):
    pin_hash(monkeypatch, slot_hash)
    xxh64 = slot_hash == "xxh64"
    # on blake2b-8 the port's edge bridge withholds fast from the edge
    mask = PORT_HELLO_BITS | (teb.HELLO_FAST if not xxh64 and door.startswith("edge") else 0)
    hellos = {}
    for name, (pkg, Resp, Status) in PKGS.items():
        inst = _fake_instance(Resp, Status, PEERS)
        if door == "geb":
            svc = pkg.GebListener(inst, "0.0.0.0:9470")
        elif door == "geb_door_map":
            svc = pkg.GebListener(inst, "0.0.0.0:9470", peer_bridges={
                "10.0.0.2:81": "10.0.0.2:7000"})
        elif door == "core":
            svc = pkg.FrameService(inst, window=8)
        elif door == "edge_unix":
            svc = pkg.EdgeBridge(inst, "/tmp/unused.sock")
        else:
            svc = pkg.EdgeBridge(inst, "/tmp/unused.sock", tcp_address="0.0.0.0:9471")
        hellos[name] = (svc._hello(), svc._hello(shm=True))
    for t, j in zip(hellos["torch"], hellos["jax"]):
        tf, jf = struct.unpack_from("<I", t, 4)[0], struct.unpack_from("<I", j, 4)[0]
        assert tf & ~mask == jf & ~mask
        assert t[:4] + t[8:] == j[:4] + j[8:]
        assert jf & teb.HELLO_FAST and jf & teb.HELLO_CHAIN  # the reference's
        assert not tf & teb.HELLO_CHAIN
        assert bool(tf & teb.HELLO_XXH64) == bool(jf & teb.HELLO_XXH64) == xxh64
        # the hash-agreement rule: fast to every client on XXH64; on
        # blake2b-8 to the blake2b client, never to the XXH64-only edge
        assert bool(tf & teb.HELLO_FAST) == (xxh64 or not door.startswith("edge"))
    hello = tclient.parse_hello_bytes(hellos["torch"][1])
    assert hello.shm and hello.trace and hello.windowed
    assert hello.fast == (xxh64 or not door.startswith("edge"))
    assert hello.xxh64 == tclient.client_hash_is_native() == xxh64


@pytest.mark.parametrize("slot_hash", HASHES)
def test_client_hash_is_the_store_slot_hash(slot_hash, monkeypatch):
    from gubernator_tpu_torch.core.hashing import slot_hash_batch, slot_hash_is_xxh64

    pin_hash(monkeypatch, slot_hash)
    keys = [f"name_key{i}" for i in range(64)] + ["", "ünï_cødé"]
    assert (tclient.client_hash_batch(keys) == slot_hash_batch(keys)).all()
    assert slot_hash_is_xxh64() == tclient.client_hash_is_native() == (slot_hash == "xxh64")


def test_the_port_hashes_xxh64_by_default():
    """Unpinned, the port's store and client select the native XXH64
    hasher (it builds with g++ here), as the JAX package selects its own
    when built."""
    from gubernator_tpu_torch.core.hashing import slot_hash_is_xxh64, using_native_hash

    assert using_native_hash() and slot_hash_is_xxh64() and tclient.client_hash_is_native()


# -- the frame core over a fake instance --------------------------------------


def _fast_rec(n, seed=0):
    req_dt, _ = teb._fast_dtypes()
    rng = np.random.default_rng(seed)
    rec = np.empty(n, req_dt)
    rec["key_hash"] = rng.integers(1, 1 << 62, n, dtype=np.uint64)
    rec["hits"] = rng.integers(0, 3, n)
    rec["limit"] = rng.integers(3, 1000, n)
    rec["duration"] = 60_000
    rec["algo"] = rng.integers(0, 4, n)
    return rec


def _frames(ring):
    """One frame of every request framing, as the client builds them."""
    payload = b"".join(_item(b"svc", b"key%d" % i, hits=1, limit=9) for i in range(5))
    chain = _chain_item(b"svc", b"leaf", [(b"head", 10, 1000)])
    fast = _fast_rec(7).tobytes()
    return {
        "GEB1": struct.pack("<III", teb.MAGIC_REQ, 5, len(payload)) + payload,
        "GEB2": struct.pack("<IIIQI", teb.MAGIC_WREQ, 5, 3, 0, len(payload)) + payload,
        "GEBT": struct.pack("<IIIQ", teb.MAGIC_WTRACE, 5, 4, 0)
        + struct.pack("<16sQB", (5).to_bytes(16, "big"), 9, 1)
        + struct.pack("<I", len(payload)) + payload,
        "GEBC": struct.pack("<IIIQI", teb.MAGIC_WCHAIN, 1, 5, 0, len(chain)) + chain,
        "GEB6": struct.pack("<IIII", teb.MAGIC_FAST_REQ, 7, ring, len(fast)) + fast,
        "GEB7": struct.pack("<IIIIQI", teb.MAGIC_WFAST_REQ, 7, 6, ring, 0, len(fast)) + fast,
        "GEB7_stale": struct.pack("<IIIIQI", teb.MAGIC_WFAST_REQ, 7, 8, ring ^ 1, 0,
                                  len(fast)) + fast,
    }


@pytest.mark.parametrize("framing", ["GEB1", "GEB2", "GEBT", "GEBC", "GEB6", "GEB7",
                                     "GEB7_stale"])
def test_serve_frame_bytes_matches_jax(framing):
    """The body-per-request door (POST /v1/geb's core) answers every
    framing with the same bytes in both packages, and refuses a stale
    ring with GEBR."""
    out = {}
    for name, (pkg, Resp, Status) in PKGS.items():
        inst = _fake_instance(Resp, Status, [FakePeer("10.0.0.1:81", is_owner=True)])
        svc = pkg.FrameService(inst)
        frame = _frames(svc._ring_hash())[framing]
        out[name] = asyncio.run(svc.serve_frame_bytes(frame))
    assert out["torch"] == out["jax"]
    if framing == "GEB7_stale":
        assert out["torch"] == struct.pack("<II", teb.MAGIC_STALE, 8)


def test_fast_frames_chunk_at_max_batch_size_in_both():
    from gubernator_tpu_torch.serve.config import MAX_BATCH_SIZE

    n = MAX_BATCH_SIZE + 500
    out, sizes = {}, {}
    for name, (pkg, Resp, Status) in PKGS.items():
        inst = _fake_instance(Resp, Status, [FakePeer("10.0.0.1:81", is_owner=True)])
        inst.batcher.sizes.clear()
        svc = pkg.FrameService(inst)
        rec = _fast_rec(n, seed=4)
        frame = struct.pack("<IIII", pkg.MAGIC_FAST_REQ, n, svc._ring_hash(),
                            rec.nbytes) + rec.tobytes()
        out[name] = asyncio.run(svc.serve_frame_bytes(frame))
        sizes[name] = list(inst.batcher.sizes)
    assert out["torch"] == out["jax"]
    assert sizes["torch"] == sizes["jax"] == [MAX_BATCH_SIZE, 500]


def test_draining_core_refuses_in_protocol_in_both():
    out = {}
    for name, (pkg, Resp, Status) in PKGS.items():
        svc = pkg.FrameService(_fake_instance(Resp, Status, [FakePeer("a:1", is_owner=True)]))
        svc._draining = True
        frames = _frames(svc._ring_hash())
        out[name] = [asyncio.run(svc.serve_frame_bytes(frames[k])) for k in ("GEB1", "GEB7")]
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == struct.pack("<II", teb.MAGIC_STALE, teb.DRAIN_FRAME_ID)
    assert b"node draining" in out["torch"][0]


# -- hostile frames on the socket doors -------------------------------------


async def _drain_hello(reader):
    _magic, _flags, rhash, n = struct.unpack("<IIII", await reader.readexactly(16))
    for _ in range(n):
        _s, glen = struct.unpack("<BH", await reader.readexactly(3))
        await reader.readexactly(glen)
        (blen,) = struct.unpack("<H", await reader.readexactly(2))
        await reader.readexactly(blen)
    return rhash


def _good_frame() -> bytes:
    payload = _item(b"api", b"ok")
    return struct.pack("<III", teb.MAGIC_REQ, 1, len(payload)) + payload


def _hostile_corpus(rng, ring_hash):
    """tests/test_geb_listener.py's corpus: garbage, truncation, lying
    counts and lengths, desynced payloads."""
    yield b"\x00" * 64
    yield rng.bytes(256)
    yield struct.pack("<II", 0xDEADBEEF, 10)
    yield struct.pack("<III", teb.MAGIC_REQ, 1000, 3) + b"abc"
    bad = struct.pack("<H", 500) + b"xx"
    yield struct.pack("<III", teb.MAGIC_REQ, 1, len(bad)) + bad
    yield struct.pack("<IIII", teb.MAGIC_FAST_REQ, 2, ring_hash, 17) + rng.bytes(17)
    yield struct.pack("<IIIIQI", teb.MAGIC_WFAST_REQ, 9999, 1, ring_hash, 0, 33) + rng.bytes(33)
    noise = rng.bytes(64)
    yield struct.pack("<IIIQI", teb.MAGIC_WREQ, 3, 2, 0, len(noise)) + noise
    payload = _item(b"\xff\xfe", b"\x80\x81")
    yield struct.pack("<III", teb.MAGIC_REQ, 1, len(payload)) + payload
    yield struct.pack("<III", teb.MAGIC_REQ, 1, 0xFFFFFFFF)
    yield struct.pack("<IIIQI", teb.MAGIC_WREQ, 1, 3, 0, teb.MAX_FRAME_PAYLOAD + 1)
    yield struct.pack("<IIII", teb.MAGIC_FAST_REQ, 1, ring_hash, 0x40000000)
    good = _good_frame()
    yield good[: len(good) // 2]


async def _send_and_read(port, frame: bytes, wait=2.0) -> bytes:
    """Send one frame on a fresh connection; the bytes read until the
    server closes (b"" = closed with no answer), or None when it kept the
    connection open for `wait` seconds."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await _drain_hello(reader)
    writer.write(frame)
    got = b""
    try:
        await writer.drain()
        while True:
            chunk = await asyncio.wait_for(reader.read(65536), wait)
            if not chunk:
                return got
            got += chunk
    except asyncio.TimeoutError:
        return None if not got else got + b"<open>"
    except (ConnectionError, OSError):
        return got
    finally:
        writer.close()


@pytest.mark.parametrize("pkg_name", ["torch", "jax"])
def test_hostile_frames_close_only_their_connection(pkg_name):
    """Every hostile frame at worst closes its own connection, the same
    way in both packages' listeners; a good frame is served after each."""
    pkg, Resp, Status = PKGS[pkg_name]

    async def run():
        (port,) = free_ports(1)
        lst = pkg.GebListener(_fake_instance(Resp, Status), f"127.0.0.1:{port}")
        await lst.start()
        rng = np.random.default_rng(1)
        answers = []
        try:
            baseline = await _send_and_read(port, _good_frame(), wait=0.3)
            for frame in _hostile_corpus(rng, ring_hash=lst._ring_hash()):
                answers.append(await _send_and_read(port, frame, wait=0.5))
                assert await _send_and_read(port, _good_frame(), wait=0.3) == baseline
        finally:
            await lst.stop()
        return baseline, answers

    baseline, answers = asyncio.run(run())
    assert baseline.endswith(b"<open>")  # answered, connection kept
    # the oversized headers close at once, before any payload is read
    assert answers[9:12] == [b"", b"", b""]
    expected = HOSTILE_OUTCOMES.setdefault(pkg_name, answers)
    assert expected == answers
    if len(HOSTILE_OUTCOMES) == 2:
        assert HOSTILE_OUTCOMES["torch"] == HOSTILE_OUTCOMES["jax"]


HOSTILE_OUTCOMES: dict = {}


def test_edge_bridge_keeps_headroom_for_large_legal_frames():
    """The trusted edge door bounds at EDGE_MAX_FRAME_PAYLOAD and keeps
    serving legal frames past the client doors' 8 MiB."""
    assert teb.EDGE_MAX_FRAME_PAYLOAD > teb.MAX_FRAME_PAYLOAD

    async def run():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "e.sock")
            br = teb.EdgeBridge(_fake_instance(TResp, TStatus), path)
            await br.start()
            try:
                reader, writer = await asyncio.open_unix_connection(path)
                await _drain_hello(reader)
                items = b"".join(_item(b"api", b"K" * 60_000 + str(i).encode())
                                 for i in range(200))
                assert len(items) > teb.MAX_FRAME_PAYLOAD
                writer.write(struct.pack("<III", teb.MAGIC_REQ, 200, len(items)) + items)
                await writer.drain()
                _magic, n = struct.unpack("<II", await asyncio.wait_for(
                    reader.readexactly(8), 15))
                writer.close()
                return n
            finally:
                await br.stop()

    assert asyncio.run(run()) == 200


def test_geb_listener_refuses_ipv6_address():
    with pytest.raises(ValueError):
        teb.GebListener(object(), "[::1]:9470")
    with pytest.raises(ValueError):
        teb.EdgeBridge(object(), "", tcp_address="[::1]:9471")


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_fuzzed_frames_answer_or_close_alike_in_both(data):
    """Hypothesis mutates well-formed frames (byte flips, truncation,
    appended garbage); each mutant, fed to both packages' listeners, must
    get the same answer or close the connection the same way."""
    frames = _frames(0)
    base = bytearray(frames[data.draw(st.sampled_from(["GEB1", "GEB2", "GEBC", "GEB6"]))])
    for _ in range(data.draw(st.integers(1, 4))):
        i = data.draw(st.integers(0, len(base) - 1))
        base[i] = data.draw(st.integers(0, 255))
    cut = data.draw(st.integers(len(base) // 2, len(base)))
    frame = bytes(base[:cut]) + data.draw(st.binary(max_size=8))

    async def run(pkg, Resp, Status):
        (port,) = free_ports(1)
        lst = pkg.GebListener(_fake_instance(Resp, Status), f"127.0.0.1:{port}")
        await lst.start()
        try:
            return await _send_and_read(port, frame, wait=0.2)
        finally:
            await lst.stop()

    got = {name: asyncio.run(run(*PKGS[name])) for name in PKGS}
    assert got["torch"] == got["jax"]
