"""The port's shared-memory GEB lane (serve/shm.py) on the CPU, against the
JAX package's where the two meet.

- The ring's validation: lying indices and torn or oversized records raise
  ShmProtocolError, as in tests/test_shm_hostile.py; honest frames wrap a
  small ring many times without a false positive.
- The mapping is one layout in both packages: a ring the port creates,
  the JAX package opens, and the other way round, byte for byte.
- The poll fallback: with the futex syscall unavailable (or
  GUBER_SHM_POLL_US set) the lane polls and still carries frames.
- A live port EdgeBridge: the lane negotiates on a unix socket only,
  carries pipelined frames, falls back to the socket for a frame past its
  bound, answers the JAX client the same way as the port's, and a hostile
  mapping (a lying head, an oversized record, ...) tears down only that
  session while other connections keep serving (tests/test_shm_lane.py).
- Decision identity on real CPU stacks: the shm lane through the edge
  bridge (string frames, folded onto the array path and hashed in the
  server) against the GEB door's fast frames (hashed by the client), one
  fake-clock stream, byte-equal answers.
"""

import asyncio
import struct

import numpy as np
import pytest

import gubernator_tpu.client_geb as jclient
import gubernator_tpu.serve.shm as jshm
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.serve.shm as tshm
from test_torch_hash import HASHES, pin_hash
from _util import free_ports
from gubernator_tpu_torch.api.types import Algorithm, RateLimitReq, RateLimitResp, Status
from gubernator_tpu_torch.client_geb import AsyncGebClient, GebError, read_hello
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.edge_bridge import EdgeBridge
from gubernator_tpu_torch.serve.shm import (
    MAGIC_SHM_OK,
    MAGIC_SHM_REQ,
    ShmClientLane,
    ShmProtocolError,
    ShmRing,
    _OFF_C2S_HEAD,
    _OFF_C2S_SEQ,
    _OFF_S2C_HEAD,
    _OFF_S2C_SEQ,
)

_U32 = struct.Struct("<I")
_DATA_OFF = 4096
T0 = 1_700_000_000_000


def _req(key, hits=1, limit=9, duration=60_000):
    return RateLimitReq(name="shmlane", unique_key=key, hits=hits, limit=limit,
                        duration=duration)


class FakeInstance:
    """Echo: UNDER_LIMIT with remaining = limit - hits."""

    async def get_rate_limits(self, reqs, stage_frame=False):
        return [RateLimitResp(status=Status.UNDER_LIMIT, limit=r.limit,
                              remaining=r.limit - r.hits, reset_time=123) for r in reqs]


def _counter(metric) -> float:
    return metric._value.get()


# -- the ring ----------------------------------------------------------------


def _pair(tmp_path, creator=tshm, opener=tshm):
    server = creator.ShmRing.create(64, dir=str(tmp_path))
    client = opener.ShmRing.open(server.path)
    return server, client


def test_ring_rejects_lying_indices(tmp_path):
    server, client = _pair(tmp_path)
    try:
        client._put_u64(_OFF_C2S_HEAD, server.c2s_cap + 999)
        with pytest.raises(ShmProtocolError, match="lying ring"):
            server.read_c2s(1 << 20)
        client._put_u64(_OFF_C2S_HEAD, 0)
        server._put_u64(_OFF_C2S_HEAD + 64, 8)  # c2s tail ahead of the head
        with pytest.raises(ShmProtocolError, match="lying ring"):
            server.read_c2s(1 << 20)
    finally:
        client.release()
        server.release()


@pytest.mark.parametrize("case,head,length,match", [
    ("torn_header", 2, None, "torn record"),
    ("zero_length", 8, 0, "outside"),
    ("oversized", 8, 0x7FFFFFF0, "outside"),
    ("beyond_head", 8, 100, "beyond published"),
])
def test_ring_rejects_torn_and_hostile_records(tmp_path, case, head, length, match):
    server, client = _pair(tmp_path)
    try:
        if length is not None:
            client._mm[_DATA_OFF:_DATA_OFF + 4] = _U32.pack(length)
        client._put_u64(_OFF_C2S_HEAD, head)
        with pytest.raises(ShmProtocolError, match=match):
            server.read_c2s(1 << 20)
    finally:
        client.release()
        server.release()


@pytest.mark.parametrize("creator,opener", [("torch", "torch"), ("torch", "jax"),
                                            ("jax", "torch")])
def test_roundtrip_wraps_and_the_layout_matches_jax(tmp_path, creator, opener):
    """Thousands of frames wrap a 64 KiB ring both ways; a ring one
    package maps, the other reads and writes: one layout."""
    mods = {"torch": tshm, "jax": jshm}
    server, client = _pair(tmp_path, mods[creator], mods[opener])
    rng = np.random.default_rng(11)
    try:
        assert (server.c2s_cap, server.s2c_cap) == (client.c2s_cap, client.s2c_cap)
        for i in range(600):
            payload = rng.bytes(int(rng.integers(1, 1500)))
            assert client.write_c2s(payload)
            assert server.read_c2s(1 << 20) == payload
            assert server.write_s2c(payload[::-1])
            assert client.read_s2c(1 << 20) == payload[::-1]
        assert bytes(server._mm[:_DATA_OFF]) == bytes(client._mm[:_DATA_OFF])
    finally:
        client.release()
        server.release()


def test_ring_full_refuses_instead_of_overwriting(tmp_path):
    server, client = _pair(tmp_path)
    try:
        n = 0
        while client.write_c2s(b"z" * 4000):
            n += 1
        assert 10 <= n <= 16  # 64 KiB of 4 KiB records
        assert server.read_c2s(1 << 20) == b"z" * 4000
        assert client.write_c2s(b"z" * 4000)  # room again
    finally:
        client.release()
        server.release()


_HAMMER = """
import sys, time
from gubernator_tpu_torch.serve.shm import ShmRing
ring = ShmRing.open(sys.argv[1])
put = ring._put_u64 if sys.argv[3] == "64" else ring._put_u32
v, step, end = int(sys.argv[4]), int(sys.argv[5]), time.monotonic() + float(sys.argv[2])
while time.monotonic() < end:
    v += step
    put(int(sys.argv[6]), v)
ring.release()
"""


@pytest.mark.parametrize("bits,off,start,step", [
    (64, tshm._OFF_C2S_TAIL, 0x0101_0101_0101, 0x0101),
    (32, tshm._OFF_C2S_SEQ, 0x0101_0101, 0x0101),
], ids=["u64_index", "u32_seq"])
def test_peer_never_reads_a_half_written_word(tmp_path, bits, off, start, step):
    """One process stores a rising header word as fast as it can while this
    one loads it: every load is a value the writer stored, never a zeroed
    or part-written one (struct.pack_into zeroes its field first, which let
    a reader see a ring index at 0 and tear a healthy lane)."""
    import os
    import subprocess
    import sys
    import time

    server = tshm.ShmRing.create(64, dir=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    get = server._u64 if bits == 64 else server._u32
    try:
        child = subprocess.Popen([sys.executable, "-c", _HAMMER, server.path, "1.0",
                                  str(bits), str(start), str(step), str(off)], env=env)
        deadline = time.monotonic() + 30
        while get(off) == 0 and child.poll() is None and time.monotonic() < deadline:
            time.sleep(0.001)
        seen, last, bad = 0, start, []
        while child.poll() is None:
            v = get(off)
            seen += 1
            if v < last or (v - start) % step:
                bad.append(v)
            last = max(last, v)
        assert child.wait() == 0
        assert last > start + 1000 * step  # the writer really ran
        assert seen > 1000 and not bad, f"{len(bad)} torn loads of {seen}: {bad[:5]}"
    finally:
        server.release()


# -- the lane on a live port bridge --------------------------------------------


async def _negotiate_raw(path):
    """The control protocol by hand: hello, GEBM, GEBN, then map the
    granted ring directly (a hostile peer's view)."""
    reader, writer = await asyncio.open_unix_connection(path)
    hello = await read_hello(reader)
    assert hello.shm
    writer.write(struct.pack("<II", MAGIC_SHM_REQ, 0))
    await writer.drain()
    magic, plen = struct.unpack("<II", await reader.readexactly(8))
    assert magic == MAGIC_SHM_OK and plen > 0
    await reader.readexactly(16)
    return reader, writer, ShmRing.open((await reader.readexactly(plen)).decode())


async def _probe(endpoint, shm="off"):
    c = AsyncGebClient(endpoint, shm=shm, timeout=10.0)
    try:
        resps = await c.get_rate_limits([_req("probe")])
        assert resps[0].status == Status.UNDER_LIMIT
        return c.stats()["transport"]
    finally:
        await c.close()


@pytest.mark.parametrize("wakeup", ["futex", "poll_fallback", "poll_us"])
def test_shm_negotiates_and_carries_frames(tmp_path, monkeypatch, wakeup):
    """Unix socket + shm-enabled bridge: the lane maps and pipelined
    frames ride the ring, under the futex, with the syscall unavailable
    (the automatic poll fallback), and with GUBER_SHM_POLL_US."""
    if wakeup == "poll_fallback":
        monkeypatch.setattr(tshm, "_futex_ok", False)
    elif wakeup == "futex" and not tshm.futex_supported():
        pytest.skip("no futex syscall on this host; the poll cases cover the lane")
    path = str(tmp_path / "b.sock")

    async def run():
        sessions0 = _counter(metrics.GEB_SHM_SESSIONS)
        frames0 = _counter(metrics.GEB_SHM_FRAMES)
        bridge = EdgeBridge(FakeInstance(), path, shm_enabled=True, shm_ring_kib=128,
                            shm_poll_us=200 if wakeup == "poll_us" else 0)
        await bridge.start()
        client = AsyncGebClient(f"unix:{path}", shm="require")
        try:
            hello = await client.connect()
            assert hello.shm and not hello.fast  # the edge bridge's hello
            if wakeup != "poll_us":  # GUBER_SHM_POLL_US sets the server's side
                assert client._lane.ring._use_futex == (wakeup == "futex")
            outs = await asyncio.gather(*[
                client.get_rate_limits([_req(f"k{i}", hits=i % 3, limit=7)])
                for i in range(20)])
            assert [r[0].remaining for r in outs] == [7 - (i % 3) for i in range(20)]
            st = client.stats()
            assert (st["transport"], st["frames_shm"], st["frames_socket"]) == ("shm", 20, 0)
            assert _counter(metrics.GEB_SHM_SESSIONS) == sessions0 + 1
            assert _counter(metrics.GEB_SHM_FRAMES) >= frames0 + 20
        finally:
            await client.close()
            await bridge.stop()

    asyncio.run(run())


def test_shm_only_on_unix_sockets_of_an_enabled_bridge(tmp_path):
    path, off_path = str(tmp_path / "b.sock"), str(tmp_path / "off.sock")
    (port,) = free_ports(1)

    async def run():
        bridge = EdgeBridge(FakeInstance(), path, tcp_address=f"127.0.0.1:{port}",
                            shm_enabled=True)
        off = EdgeBridge(FakeInstance(), off_path)
        await bridge.start()
        await off.start()
        try:
            assert await _probe(f"127.0.0.1:{port}", shm="auto") == "tcp"
            assert await _probe(f"unix:{off_path}", shm="auto") == "unix"
            for endpoint in (f"127.0.0.1:{port}", f"unix:{off_path}"):
                hard = AsyncGebClient(endpoint, shm="require")
                with pytest.raises(GebError, match="no lane mapped"):
                    await hard.connect()
                await hard.close()
        finally:
            await bridge.stop()
            await off.stop()

    asyncio.run(run())


def test_oversized_frame_falls_back_to_socket(tmp_path):
    path = str(tmp_path / "b.sock")

    async def run():
        bridge = EdgeBridge(FakeInstance(), path, shm_enabled=True, shm_ring_kib=64)
        await bridge.start()
        client = AsyncGebClient(f"unix:{path}", shm="require")
        try:
            await client.connect()
            small = await client.get_rate_limits([_req("s")])
            big = await client.get_rate_limits([_req("b" * 30_000, limit=5)])
            assert (small[0].status, big[0].status, big[0].limit) == (
                Status.UNDER_LIMIT, Status.UNDER_LIMIT, 5)
            st = client.stats()
            assert (st["frames_shm"], st["frames_socket"]) == (1, 1)
        finally:
            await client.close()
            await bridge.stop()

    asyncio.run(run())


def test_jax_client_lane_against_the_port_bridge(tmp_path):
    """The JAX package's client negotiates and uses the port's lane."""
    path = str(tmp_path / "b.sock")

    async def run():
        bridge = EdgeBridge(FakeInstance(), path, shm_enabled=True, shm_ring_kib=64)
        await bridge.start()
        client = jclient.AsyncGebClient(f"unix:{path}", shm="require")
        try:
            await client.connect()
            import gubernator_tpu.api.types as jt

            outs = await asyncio.gather(*[client.get_rate_limits([jt.RateLimitReq(
                name="j", unique_key=f"k{i}", hits=1, limit=4, duration=1000)])
                for i in range(8)])
            assert all(o[0].remaining == 3 for o in outs)
            assert client.stats()["frames_shm"] == 8
        finally:
            await client.close()
            await bridge.stop()

    asyncio.run(run())


def _mutations():
    def lying_head(ring):
        ring._put_u64(_OFF_C2S_HEAD, ring.c2s_cap + 12345)

    def zero_len_record(ring):
        ring._mm[_DATA_OFF:_DATA_OFF + 4] = _U32.pack(0)
        ring._put_u64(_OFF_C2S_HEAD, 8)
        ring._bump_wake(_OFF_C2S_SEQ)

    def oversized_record(ring):
        ring._mm[_DATA_OFF:_DATA_OFF + 4] = _U32.pack(0x7FFFFFF0)
        ring._put_u64(_OFF_C2S_HEAD, 8)
        ring._bump_wake(_OFF_C2S_SEQ)

    def torn_header(ring):
        ring._put_u64(_OFF_C2S_HEAD, 2)
        ring._bump_wake(_OFF_C2S_SEQ)

    def len_beyond_head(ring):
        ring._mm[_DATA_OFF:_DATA_OFF + 4] = _U32.pack(5000)
        ring._put_u64(_OFF_C2S_HEAD, 8)
        ring._bump_wake(_OFF_C2S_SEQ)

    def garbage_frame(ring):
        ring.write_c2s(b"\xde\xad\xbe\xef" * 4)

    return [lying_head, zero_len_record, oversized_record, torn_header,
            len_beyond_head, garbage_frame]


@pytest.mark.parametrize("mutate", _mutations(), ids=lambda f: f.__name__)
def test_hostile_mapping_tears_down_only_its_session(tmp_path, mutate):
    """The mutation kills its own lane (teardown counted, control socket
    closed) and nothing else: a long-lived clean shm client, a clean unix
    client and a clean TCP client keep serving."""
    path = str(tmp_path / "b.sock")
    (port,) = free_ports(1)

    async def run():
        bridge = EdgeBridge(FakeInstance(), path, tcp_address=f"127.0.0.1:{port}",
                            shm_enabled=True, shm_ring_kib=64)
        await bridge.start()
        bystander = AsyncGebClient(f"unix:{path}", shm="require")
        await bystander.connect()
        try:
            before = _counter(metrics.GEB_SHM_TEARDOWNS)
            reader, writer, ring = await _negotiate_raw(path)
            try:
                mutate(ring)
                assert await asyncio.wait_for(reader.read(1), 5.0) == b""
                assert _counter(metrics.GEB_SHM_TEARDOWNS) > before
            finally:
                writer.close()
                ring.release()
            assert await _probe(f"unix:{path}") == "unix"
            assert await _probe(f"127.0.0.1:{port}") == "tcp"
            r = await bystander.get_rate_limits([_req("by")])
            assert r[0].status == Status.UNDER_LIMIT
            assert bystander.stats()["transport"] == "shm"
        finally:
            await bystander.close()
            await bridge.stop()

    asyncio.run(run())


def test_client_lane_tears_down_on_lying_server(tmp_path):
    async def run():
        server = ShmRing.create(64, dir=str(tmp_path))
        lane = ShmClientLane(server.path)
        torn = asyncio.get_running_loop().create_future()
        lane.start(asyncio.get_running_loop(), lambda data: None,
                   lambda exc: (not torn.done()) and torn.set_result(exc),
                   max_resp_len=1 << 20)
        try:
            assert lane.try_send(b"x" * 64)
            server._put_u64(_OFF_S2C_HEAD, server.s2c_cap + 77)
            server._bump_wake(_OFF_S2C_SEQ)
            assert isinstance(await asyncio.wait_for(torn, 5.0), ShmProtocolError)
            assert lane.try_send(b"y" * 64) is False
        finally:
            lane.close()
            server.release()

    asyncio.run(run())


# -- decision identity on real CPU stacks ------------------------------------


class FakeClock:
    def __init__(self):
        self.t = T0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("slot_hash", HASHES)
def test_shm_lane_vs_geb_fast_door_identity(monkeypatch, tmp_path, slot_hash):
    """Two fresh one-node port stacks, one fake-clock stream: string
    frames through the shm lane (folded, hashed in the server) and fast
    frames through the GEB door (hashed by the client) answer byte-equal —
    the two doors hash a key into the same row, on either slot hash."""
    from gubernator_tpu_torch.cluster import LocalCluster
    from gubernator_tpu_torch.core.store import StoreConfig
    from gubernator_tpu_torch.serve.backends import TorchBackend

    clock = FakeClock()
    monkeypatch.setattr(t_types, "millisecond_now", clock)
    pin_hash(monkeypatch, slot_hash)
    path = str(tmp_path / "d.sock")
    ports = free_ports(3)

    def be():
        return TorchBackend(StoreConfig(rows=16, slots=1 << 10), buckets=(64, 256, 1024),
                            device="cpu")

    clusters = [
        LocalCluster([f"127.0.0.1:{ports[0]}"], backend_factory=be, geb_ports=[ports[2]]),
        LocalCluster([f"127.0.0.1:{ports[1]}"], backend_factory=be),
    ]
    for c in clusters:
        c.start()
        c.servers[0].instance.shed.now_fn = clock

    async def bridge_up():
        b = EdgeBridge(clusters[1].servers[0].instance, path, shm_enabled=True,
                       shm_ring_kib=256)
        await b.start()
        return b

    bridge = clusters[1].run(bridge_up())
    folded0 = _counter(metrics.EDGE_FOLDED_ITEMS)
    try:
        async def run():
            fast = AsyncGebClient(f"127.0.0.1:{ports[2]}", mode="fast", shm="off")
            shm = AsyncGebClient(f"unix:{path}", mode="string", shm="require")
            rng = np.random.default_rng(47)
            try:
                await shm.connect()
                await fast.connect()
                assert fast._use_fast and not shm._use_fast
                for step in range(60):
                    batch = [RateLimitReq(
                        name="shmdoor", unique_key=f"sk{int(k)}",
                        hits=int(rng.choice([0, 1, 1, 2, 9])),
                        limit=int(rng.choice([1, 2, 3, 50])),
                        duration=int(rng.choice([400, 2000, 60_000])),
                        algorithm=Algorithm(int(k) % 4))
                        for k in rng.integers(0, 12, int(rng.integers(1, 7)))]
                    clock.t += int(rng.choice([0, 0, 1, 7, 150, 500, 2500]))
                    a = await fast.get_rate_limits(batch)
                    b = await shm.get_rate_limits(batch)
                    ta = [(int(x.status), x.limit, x.remaining, x.reset_time, x.error) for x in a]
                    tb = [(int(x.status), x.limit, x.remaining, x.reset_time, x.error) for x in b]
                    assert ta == tb, step
                assert shm.stats()["frames_shm"] == 60
            finally:
                await fast.close()
                await shm.close()

        asyncio.run(run())
        assert _counter(metrics.EDGE_FOLDED_ITEMS) > folded0
    finally:
        clusters[1].run(bridge.stop())
        for c in clusters:
            c.stop()
