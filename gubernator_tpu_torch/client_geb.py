"""First-class GEB client protocol (r12): the windowed binary frame
protocol as a PUBLIC client surface.

The port's copy of gubernator_tpu/client_geb.py with its imports
rewritten; the file references below are the reference package's. The
one difference: the port has no native hasher, so `client_hash_batch`
is blake2b-8 (the port store's slot hash, core/hashing.py) and
`client_hash_is_native()` is False. Against the port's doors, which
advertise fast framing without HELLO_XXH64, that agreement turns fast
framing on.

r10's profiling found the doors clients could actually reach (gRPC
protobuf, HTTP JSON) ceiling at ~110k dec/s on this class of box while
the internal windowed GEB framing sustains 340-560k on the same
hardware — the serialization/RPC tier, not the engine, was the
front-door bottleneck. This module closes that gap from the client
side: a torch-free client (like `gubernator_tpu_torch.client`) that speaks the
bridge wire protocol directly to

  - a daemon's GEB listener (`GUBER_GEB_PORT`, serve/edge_bridge.py
    GebListener) — 'host:port',
  - a co-located bridge socket — '/path.sock' or 'unix:/path.sock',

with hello/version negotiation, credit-windowed pipelining (up to the
server's advertised window of frames in flight per connection,
completed out of order), reconnect, and the GEBR drain/stale-ring
refusal semantics of r7/r8 honored.

Framing choice (`mode`):

  - 'string' — GEB2 windowed string frames (GEB1 against a pre-r7
    server). Items carry name/key; the daemon validates, routes, and
    forwards exactly as the gRPC door does. Correct on ANY topology.
  - 'fast' — GEB7 windowed pre-hashed frames (GEB6 legacy). The client
    hashes `name_key` itself and the daemon's array path decides the
    items locally with no per-item Python — the edge binary's fast
    path, from a library. Requires the client and the store to run the
    SAME slot hash (the hello's HELLO_XXH64 bit advertises the
    server's implementation) and, because fast frames bypass instance
    routing, keys this node actually owns.
  - 'auto' (default) — fast when the hello advertises it, the hash
    implementations agree, and the ring is single-node (where every
    key is owned by construction); string otherwise, and per batch for
    requests fast framing cannot carry (GLOBAL/NO_BATCHING behaviors,
    empty name/key). Multi-node fast routing remains the compiled
    edge's job.

Delivery semantics: a frame refused by GEBR (stale ring or drain) was
NOT served — retrying it (elsewhere) is safe, and the raised error
says so. A connection lost mid-flight leaves in-doubt frames
(`GebConnectionError`); whether their hits were applied is unknown,
the same at-most-once stance as the peer-forwarding tier.

The wire constants here are deliberate duplicates of
serve/edge_bridge.py's (this module must not import the serving tier);
tests/test_geb_client.py pins them equal.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import logging
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.endpoints import parse_endpoint

__all__ = [
    "AsyncGebClient",
    "GebClient",
    "AsyncHttpGebClient",
    "GebError",
    "GebStaleRingError",
    "GebDrainingError",
    "GebConnectionError",
    "GEB_CONTENT_TYPE",
    "GEB_HTTP_PATH",
]

# -- wire constants (mirrors of serve/edge_bridge.py, test-pinned) ----------

MAGIC_REQ = 0x31424547  # 'GEB1'
MAGIC_RESP = 0x33424547  # 'GEB3'
MAGIC_HELLO = 0x49424547  # 'GEBI'
MAGIC_FAST_REQ = 0x36424547  # 'GEB6'
MAGIC_FAST_RESP = 0x35424547  # 'GEB5'
MAGIC_STALE = 0x52424547  # 'GEBR'
MAGIC_WREQ = 0x32424547  # 'GEB2'
MAGIC_WRESP = 0x34424547  # 'GEB4'
MAGIC_WFAST_REQ = 0x37424547  # 'GEB7'
MAGIC_WFAST_RESP = 0x38424547  # 'GEB8'
MAGIC_WCHAIN = 0x43424547  # 'GEBC' — chain-extended string req (r15)
MAGIC_WTRACE = 0x54424547  # 'GEBT' — trace-extended string req (r16)
MAGIC_SHM_REQ = 0x4D424547  # 'GEBM' — map a shared-memory lane (r18)
MAGIC_SHM_OK = 0x4E424547  # 'GEBN' — lane reply (path_len 0 = refused)

HELLO_FAST = 1
HELLO_WINDOWED = 2
HELLO_XXH64 = 4
HELLO_CHAIN = 8  # server accepts GEBC chain-extended frames (r15)
HELLO_TRACE = 16  # server accepts GEBT trace-extended frames (r16)
HELLO_SHM = 32  # this connection may negotiate the shm lane (r18)

log = logging.getLogger("gubernator_tpu_torch.client_geb")

DRAIN_FRAME_ID = 0xFFFFFFFF

_HDR = struct.Struct("<II")
_ITEM_FIX = struct.Struct("<qqqBB")
_RESP_FIX = struct.Struct("<Bqqq")
_WFAST_HDR = struct.Struct("<IIQ")  # frame_id | ring_hash | t_sent_us
_WREQ_HDR = struct.Struct("<IQ")  # frame_id | t_sent_us
# GEBT trace extension after _WREQ_HDR (r16): 16B big-endian trace id,
# u64 span id, u8 flags (bit 0 = sampled)
_WTRACE_EXT = struct.Struct("<16sQB")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_FAST_REQ = struct.Struct("<QqqqB")  # key_hash|hits|limit|duration|algo

#: content type gating the HTTP gateway's binary door (POST /v1/geb)
GEB_CONTENT_TYPE = "application/x-guber-geb"
GEB_HTTP_PATH = "/v1/geb"

#: frames beyond this refuse client-side: the daemon chunks at its own
#: batch ladder, but an unbounded frame is an unbounded host alloc
MAX_FRAME_ITEMS = 65536

#: hard cap on one frame's payload bytes, mirroring the server's
#: read-side bound (edge_bridge.MAX_FRAME_PAYLOAD, test-pinned): the
#: server kills any connection advertising more before buffering it,
#: so refuse loudly here instead of dying with a dropped connection
MAX_FRAME_PAYLOAD = 8 << 20


def _check_wire_count(n: int) -> int:
    """Bound a server-supplied response item count BEFORE sizing a
    read from it — the mirror of the server's lying-length defense: a
    byzantine or desynced peer advertising a ~4G count must raise, not
    buffer gigabytes toward readexactly."""
    if n > MAX_FRAME_ITEMS:
        raise GebError(
            f"response item count {n} exceeds the "
            f"{MAX_FRAME_ITEMS}-item frame bound"
        )
    return n


class GebError(Exception):
    """Protocol-level client error."""


class GebStaleRingError(GebError):
    """The server refused the frame: routed under a stale membership
    view (GEBR). The frame was NOT served; reconnecting re-reads the
    hello (fresh ring) and retrying is safe."""


class GebDrainingError(GebError):
    """The server is draining (GEBR drain code): this frame was NOT
    served and the listener is closing. Retry against another node."""


class GebConnectionError(GebError):
    """Connection lost with frames in flight: whether their hits were
    applied is unknown (at-most-once ambiguity, like a failed peer
    forward). Peek-only batches are always safe to retry."""


# -- client-side slot hashing (fast framing) --------------------------------


def client_hash_is_native() -> bool:
    """True when this process hashes with a native XXH64 library — must
    match the server's HELLO_XXH64 bit for fast framing. The port has
    none: always False."""
    return False


def client_hash_batch(keys: Sequence[str]):
    """uint64 slot hashes, identical to the daemon's
    core.hashing.slot_hash_batch: blake2b-8, little-endian. Kept here,
    not imported, so this client loads no torch."""
    import numpy as np

    return np.array(
        [
            int.from_bytes(
                hashlib.blake2b(
                    k.encode("utf-8"), digest_size=8
                ).digest(),
                "little",
            )
            for k in keys
        ],
        dtype=np.uint64,
    )


# -- hello ------------------------------------------------------------------


@dataclass
class Hello:
    """Parsed GEBI hello: capability flags, credit window, ring
    fingerprint, and the live membership (grpc address, that node's
    frame-door endpoint, is_self)."""

    flags: int = 0
    ring_hash: int = 0
    nodes: List[Tuple[bool, str, str]] = field(default_factory=list)

    @property
    def windowed(self) -> bool:
        return bool(self.flags & HELLO_WINDOWED)

    @property
    def fast(self) -> bool:
        return bool(self.flags & HELLO_FAST)

    @property
    def xxh64(self) -> bool:
        return bool(self.flags & HELLO_XXH64)

    @property
    def chain(self) -> bool:
        return bool(self.flags & HELLO_CHAIN)

    @property
    def trace(self) -> bool:
        return bool(self.flags & HELLO_TRACE)

    @property
    def shm(self) -> bool:
        return bool(self.flags & HELLO_SHM)

    @property
    def window(self) -> int:
        return max(1, self.flags >> 16) if self.windowed else 1


async def read_hello(reader: asyncio.StreamReader) -> Hello:
    magic, flags, rhash, n_nodes = struct.unpack(
        "<IIII", await reader.readexactly(16)
    )
    if magic != MAGIC_HELLO:
        raise GebError(
            f"endpoint did not speak GEB (hello magic {magic:#x})"
        )
    if n_nodes > 4096:
        raise GebError(f"implausible hello node count {n_nodes}")
    nodes = []
    for _ in range(n_nodes):
        is_self, glen = struct.unpack(
            "<BH", await reader.readexactly(3)
        )
        grpc = (await reader.readexactly(glen)).decode()
        (blen,) = _U16.unpack(await reader.readexactly(2))
        bridge = (await reader.readexactly(blen)).decode()
        nodes.append((bool(is_self), grpc, bridge))
    return Hello(flags=flags, ring_hash=rhash, nodes=nodes)


def parse_hello_bytes(buf: bytes) -> Hello:
    """Parse one complete hello from a byte buffer (the HTTP door's
    GET /v1/geb response)."""
    if len(buf) < 16:
        raise GebError("short hello")
    magic, flags, rhash, n_nodes = struct.unpack_from("<IIII", buf, 0)
    if magic != MAGIC_HELLO:
        raise GebError(f"bad hello magic {magic:#x}")
    if n_nodes > 4096:
        raise GebError(f"implausible hello node count {n_nodes}")
    off = 16
    nodes = []
    try:
        for _ in range(n_nodes):
            is_self, glen = struct.unpack_from("<BH", buf, off)
            off += 3
            grpc = buf[off : off + glen].decode()
            off += glen
            (blen,) = _U16.unpack_from(buf, off)
            off += 2
            bridge = buf[off : off + blen].decode()
            off += blen
            nodes.append((bool(is_self), grpc, bridge))
    except (struct.error, UnicodeDecodeError) as e:
        raise GebError(f"malformed hello: {e}") from None
    return Hello(flags=flags, ring_hash=rhash, nodes=nodes)


# -- frame codec ------------------------------------------------------------


def _fast_eligible_item(r: RateLimitReq) -> bool:
    """Per-item fast-framing eligibility (the ring router partitions
    on this): BATCHING behavior, non-empty name/key, no quota chain."""
    return bool(
        r.behavior == Behavior.BATCHING
        and r.name
        and r.unique_key
        and not r.chain
    )


def _fast_eligible(reqs: Sequence[RateLimitReq]) -> bool:
    """Fast records carry (hash, hits, limit, duration, algo) only: no
    behavior, no validation-error channel, no quota-chain levels.
    GLOBAL/NO_BATCHING items, empty names/keys, and chained requests
    (r15 — the 33-byte record has no varlen room) must ride string
    frames."""
    return all(_fast_eligible_item(r) for r in reqs)


def encode_fast_payload(reqs: Sequence[RateLimitReq]) -> bytes:
    """n x 33-byte pre-hashed records (the edge binary's encoding)."""
    import numpy as np

    hashes = client_hash_batch([r.hash_key() for r in reqs])
    rec = np.zeros(
        len(reqs),
        dtype=np.dtype(
            [
                ("key_hash", "<u8"),
                ("hits", "<i8"),
                ("limit", "<i8"),
                ("duration", "<i8"),
                ("algo", "u1"),
            ]
        ),
    )
    rec["key_hash"] = hashes
    rec["hits"] = [r.hits for r in reqs]
    rec["limit"] = [r.limit for r in reqs]
    rec["duration"] = [r.duration for r in reqs]
    rec["algo"] = [int(r.algorithm) for r in reqs]
    return rec.tobytes()


def encode_string_payload(reqs: Sequence[RateLimitReq]) -> bytes:
    parts = []
    for r in reqs:
        name = r.name.encode()
        key = r.unique_key.encode()
        if len(name) > 0xFFFF or len(key) > 0xFFFF:
            raise GebError("name/unique_key exceed 65535 bytes")
        parts.append(_U16.pack(len(name)))
        parts.append(name)
        parts.append(_U16.pack(len(key)))
        parts.append(key)
        parts.append(
            _ITEM_FIX.pack(
                r.hits,
                r.limit,
                r.duration,
                int(r.algorithm),
                int(r.behavior),
            )
        )
    return b"".join(parts)


def encode_chain_payload(reqs: Sequence[RateLimitReq]) -> bytes:
    """GEBC chain-extended items (r15): each string item followed by a
    u8 level count and that many (u16 key_len | key | i64 limit |
    i64 duration) ancestor levels, shallow to deep. Plain items ride
    with a 0 count, so one mixed batch stays one frame."""
    parts = []
    for r in reqs:
        name = r.name.encode()
        key = r.unique_key.encode()
        if len(name) > 0xFFFF or len(key) > 0xFFFF:
            raise GebError("name/unique_key exceed 65535 bytes")
        chain = getattr(r, "chain", None) or []
        if len(chain) > 0xFF:
            raise GebError("chain exceeds 255 levels")
        parts.append(_U16.pack(len(name)))
        parts.append(name)
        parts.append(_U16.pack(len(key)))
        parts.append(key)
        parts.append(
            _ITEM_FIX.pack(
                r.hits,
                r.limit,
                r.duration,
                int(r.algorithm),
                int(r.behavior),
            )
        )
        parts.append(struct.pack("<B", len(chain)))
        for lv in chain:
            lk = lv.unique_key.encode()
            if len(lk) > 0xFFFF:
                raise GebError("chain level key exceeds 65535 bytes")
            parts.append(_U16.pack(len(lk)))
            parts.append(lk)
            parts.append(struct.pack("<qq", lv.limit, lv.duration))
    return b"".join(parts)


def decode_fast_body(body: bytes, n: int) -> List[RateLimitResp]:
    if len(body) != n * 25:
        raise GebError("fast response length mismatch")
    out = []
    off = 0
    for _ in range(n):
        st, limit, rem, reset = _RESP_FIX.unpack_from(body, off)
        off += _RESP_FIX.size
        if st not in (0, 1):
            # a corrupted or future-version status must fail loudly,
            # never decode fail-open as "allowed"
            raise GebError(f"bad status byte {st:#x} in fast response")
        out.append(
            RateLimitResp(
                status=Status(st),
                limit=limit,
                remaining=rem,
                reset_time=reset,
            )
        )
    return out


def decode_string_body(body: bytes, n: int) -> List[RateLimitResp]:
    """Parse n GEB3/GEB4 response items (varlen error/owner) from a
    complete buffer."""
    out = []
    off = 0
    try:
        for _ in range(n):
            st, limit, rem, reset = _RESP_FIX.unpack_from(body, off)
            off += _RESP_FIX.size
            (elen,) = _U16.unpack_from(body, off)
            off += 2
            err = body[off : off + elen].decode()
            off += elen
            (olen,) = _U16.unpack_from(body, off)
            off += 2
            owner = body[off : off + olen].decode()
            off += olen
            out.append(_string_resp(st, limit, rem, reset, err, owner))
    except (struct.error, UnicodeDecodeError) as e:
        raise GebError(f"malformed string response: {e}") from None
    if off != len(body):
        raise GebError("trailing bytes in string response")
    return out


def _string_resp(st, limit, rem, reset, err, owner) -> RateLimitResp:
    if st not in (0, 1):
        # fail loudly, never fail-open as "allowed" (see decode_fast_body)
        raise GebError(f"bad status byte {st:#x} in string response")
    r = RateLimitResp(
        status=Status(st),
        limit=limit,
        remaining=rem,
        reset_time=reset,
        error=err,
    )
    if owner:
        r.metadata["owner"] = owner
    return r


def build_frame(
    reqs: Sequence[RateLimitReq],
    fast: bool,
    windowed: bool,
    frame_id: int = 0,
    ring_hash: int = 0,
    t_sent_us: int = 0,
    trace_ctx=None,
) -> Tuple[bytes, bool]:
    """Encode one request frame; returns (bytes, is_fast).

    `trace_ctx` (r16, a serve/tracing.TraceContext) emits the GEBT
    trace-extended framing — windowed string frames only. It is
    silently dropped for fast frames (the 33-byte records are
    trace-free by design; the server head-samples those bridge-side)
    and for chained frames (GEBC has no trace slot — documented scope
    limit)."""
    if not reqs:
        raise GebError("empty request batch")
    if len(reqs) > MAX_FRAME_ITEMS:
        raise GebError(
            f"batch of {len(reqs)} exceeds the {MAX_FRAME_ITEMS}-item "
            f"frame bound; split it"
        )
    chained = any(getattr(r, "chain", None) for r in reqs)
    if chained and not windowed:
        raise GebError(
            "quota chains need the windowed GEBC framing; this server "
            "negotiated the legacy single-frame protocol (pre-r7)"
        )
    use_fast = fast and not chained and _fast_eligible(reqs)
    payload = (
        encode_fast_payload(reqs)
        if use_fast
        else encode_chain_payload(reqs)
        if chained
        else encode_string_payload(reqs)
    )
    if len(payload) > MAX_FRAME_PAYLOAD:
        # in practice only string frames with very long names/keys get
        # here (a max-item fast frame is ~2.1 MiB), but both framings
        # are bounded: the server refuses anything beyond the cap by
        # killing the connection, so fail loudly before the wire
        raise GebError(
            f"frame payload of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_PAYLOAD}-byte bound; split the batch"
        )
    if use_fast:
        if windowed:
            hdr = _HDR.pack(MAGIC_WFAST_REQ, len(reqs)) + _WFAST_HDR.pack(
                frame_id, ring_hash, t_sent_us
            )
        else:
            hdr = _HDR.pack(MAGIC_FAST_REQ, len(reqs)) + _U32.pack(
                ring_hash
            )
        return hdr + _U32.pack(len(payload)) + payload, True
    if windowed:
        if trace_ctx is not None and not chained:
            hdr = (
                _HDR.pack(MAGIC_WTRACE, len(reqs))
                + _WREQ_HDR.pack(frame_id, t_sent_us)
                + _WTRACE_EXT.pack(
                    (trace_ctx.trace_id & ((1 << 128) - 1)).to_bytes(
                        16, "big"
                    ),
                    trace_ctx.span_id & ((1 << 64) - 1),
                    1 if trace_ctx.sampled else 0,
                )
            )
        else:
            hdr = _HDR.pack(
                MAGIC_WCHAIN if chained else MAGIC_WREQ, len(reqs)
            ) + _WREQ_HDR.pack(frame_id, t_sent_us)
    else:
        hdr = _HDR.pack(MAGIC_REQ, len(reqs))
    return hdr + _U32.pack(len(payload)) + payload, use_fast


async def negotiate_shm(reader, writer, on_frame, on_torn, poll_us: int = 0):
    """Map the shared-memory lane (r18) on a unix connection whose hello
    advertised HELLO_SHM and whose responses nothing reads yet: send
    GEBM, read the GEBN reply inline, open the lane and start it on the
    running loop with `on_frame(bytes)` for each response frame and
    `on_torn(exc)` when it dies. Returns the started ShmClientLane, or
    None when the server refused (path_len 0)."""
    writer.write(_HDR.pack(MAGIC_SHM_REQ, 0))
    await writer.drain()
    magic, plen = _HDR.unpack(await reader.readexactly(8))
    if magic != MAGIC_SHM_OK:
        raise GebError(f"bad shm negotiation reply magic {magic:#x}")
    if plen == 0:
        return None
    if plen > 4096:
        raise GebError(f"implausible shm path length {plen}")
    await reader.readexactly(16)  # ring caps; the header governs
    path = (await reader.readexactly(plen)).decode()
    # stdlib-only module (no torch); lazy so socket-only clients never
    # touch it
    from gubernator_tpu_torch.serve.shm import ShmClientLane

    lane = ShmClientLane(path, poll_us=poll_us)
    lane.start(
        asyncio.get_running_loop(),
        on_frame,
        on_torn,
        max_resp_len=MAX_FRAME_PAYLOAD + 64,
    )
    return lane


# -- async client -----------------------------------------------------------


class AsyncGebClient:
    """Asyncio GEB client: one connection, up to the negotiated credit
    window of frames in flight, completed out of order. Concurrent
    `get_rate_limits` calls pipeline onto the same connection — that
    is the throughput model (the r7 windowed protocol); one call alone
    still pays a single round trip."""

    def __init__(
        self,
        endpoint: str,
        window: int = 0,
        mode: str = "auto",
        timeout: Optional[float] = None,
        shm: str = "auto",
        ring_route: Optional[bool] = None,
    ):
        """`shm` (r18): 'auto' maps the shared-memory lane when the
        endpoint is a unix socket and the hello advertises HELLO_SHM
        (frames fall back to the control socket transparently when the
        ring is full or torn); 'off' never negotiates; 'require' raises
        at connect() unless the lane maps. `ring_route` (r18): on a
        multi-node ring, shard fast frames per owner across per-node
        connections instead of downgrading to string frames — default
        from GUBER_CLIENT_RING_ROUTE (off). Ignored when routing can't
        be sound (no fast capability, hash mismatch, missing peer
        doors); stats() says why."""
        if mode not in ("auto", "fast", "string"):
            raise ValueError("mode must be 'auto', 'fast', or 'string'")
        if shm not in ("auto", "off", "require"):
            raise ValueError("shm must be 'auto', 'off', or 'require'")
        self._kind, self._addr = parse_endpoint(
            endpoint, "GEB endpoint"
        )
        self.endpoint = endpoint
        self.mode = mode
        self.timeout = timeout
        self.shm = shm
        if ring_route is None:
            ring_route = os.environ.get(
                "GUBER_CLIENT_RING_ROUTE", "0"
            ).lower() not in ("0", "false", "no", "off", "")
        self.ring_route = bool(ring_route)
        self._want_window = window
        self.hello: Optional[Hello] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer = None
        self._read_task: Optional[asyncio.Task] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._inflight: dict = {}
        self._next_id = 1
        self._use_fast = False
        self._windowed = True
        self._window = 1
        self._legacy_lock: Optional[asyncio.Lock] = None
        self._conn_lock: Optional[asyncio.Lock] = None
        self._closed = False
        # r18 satellite: auto-mode downgrades to string frames were
        # silent — count them, log once, and surface the reason
        self._downgrades = 0
        self._downgrade_reason: Optional[str] = None
        self._downgrade_logged = False
        # r18 shm lane + ring router state
        self._lane = None
        self._ring_hash_override: Optional[int] = None
        self._router: Optional["_RingRouter"] = None
        self._frames_socket = 0
        self._frames_shm = 0

    # -- connection ---------------------------------------------------------

    async def connect(self) -> Hello:
        """Open (or reuse) the connection and return the parsed hello.
        Reconnecting after a failure re-reads the hello — a GEBR
        stale-ring refusal is healed exactly this way."""
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None:
                return self.hello
            if self._closed:
                raise GebError("client is closed")
            if self._kind == "unix":
                reader, writer = await asyncio.open_unix_connection(
                    self._addr
                )
            else:
                host, port = self._addr
                reader, writer = await asyncio.open_connection(host, port)
            try:
                hello = await read_hello(reader)
            except Exception:
                writer.close()
                raise
            self._negotiate(hello)
            self.hello = hello
            self._reader, self._writer = reader, writer
            self._inflight = {}
            self._sem = asyncio.Semaphore(self._window)
            self._legacy_lock = asyncio.Lock()
            if self.shm != "off":
                # negotiate BEFORE the read loop owns the reader: the
                # GEBN reply is the only frame read inline post-hello
                mapped = False
                if (
                    self._kind == "unix"
                    and self._windowed
                    and hello.shm
                ):
                    try:
                        mapped = await self._negotiate_shm(
                            reader, writer
                        )
                    except Exception:
                        writer.close()
                        self._reader = self._writer = None
                        raise
                if self.shm == "require" and not mapped:
                    writer.close()
                    self._reader = self._writer = None
                    raise GebError(
                        "shm='require' but no lane mapped (endpoint "
                        "not a unix socket, server without HELLO_SHM, "
                        "or the server refused the ring)"
                    )
            if self._windowed:
                self._read_task = asyncio.ensure_future(
                    self._read_loop(reader, writer)
                )
        if self.ring_route and self._router is None:
            # outside _conn_lock: the router opens more AsyncGebClients
            # whose own connect() must not deadlock on re-entry
            self._maybe_start_router()
        return self.hello

    def _negotiate(self, hello: Hello) -> None:
        self._windowed = hello.windowed
        self._window = hello.window
        if self._want_window > 0:
            self._window = max(1, min(self._window, self._want_window))
        if self.mode == "string":
            self._use_fast = False
            return
        if self.mode == "fast":
            if not hello.fast:
                raise GebError(
                    "mode='fast' but the server does not advertise the "
                    "pre-hashed fast path (non-array backend or "
                    "GUBER_EDGE_FAST=0)"
                )
            # forced: the caller asserts topology/hash agreement
            self._use_fast = True
            return
        # auto: fast only when provably sound — hash implementations
        # agree and the ring is single-node (fast frames bypass
        # instance routing; multi-node fast routing is the edge's job,
        # or — with ring_route (r18) — the router's below)
        self._use_fast = (
            hello.fast
            and hello.xxh64 == client_hash_is_native()
            and len(hello.nodes) <= 1
        )
        if not self._use_fast:
            if not hello.fast:
                reason = "hello capability (no fast path advertised)"
            elif hello.xxh64 != client_hash_is_native():
                reason = "hash mismatch (server/client XXH64 tiers)"
            else:
                reason = "multi-node ring (fast frames bypass routing)"
            if self.ring_route and reason.startswith("multi-node"):
                # the router rescues exactly this case — not a
                # downgrade; _maybe_start_router records if it can't
                return
            self._downgrades += 1
            self._downgrade_reason = reason
            if not self._downgrade_logged:
                self._downgrade_logged = True
                log.info(
                    "geb client %s: auto mode downgraded to string "
                    "frames — %s (logged once; see stats())",
                    self.endpoint,
                    reason,
                )

    async def _negotiate_shm(self, reader, writer) -> bool:
        """Map the shared-memory lane (r18) before the windowed read
        loop owns the reader. False = server refused (path_len 0) — the
        connection simply continues on the socket."""
        lane = await negotiate_shm(
            reader,
            writer,
            self._on_ring_frame,
            self._on_ring_torn,
            poll_us=int(os.environ.get("GUBER_SHM_POLL_US", "0") or 0),
        )
        if lane is None:
            return False
        self._lane = lane
        return True

    def _on_ring_frame(self, data: bytes) -> None:
        """One complete response frame popped from the s2c ring
        (event-loop thread). The lane carries the exact socket frame
        bytes, so this is `_read_loop`'s parse over a buffer."""
        try:
            magic, n = _HDR.unpack_from(data, 0)
            if magic == MAGIC_STALE:
                if n == DRAIN_FRAME_ID:
                    exc: GebError = GebDrainingError(
                        f"{self.endpoint} is draining; frame not "
                        f"served (safe to retry elsewhere)"
                    )
                else:
                    exc = GebStaleRingError(
                        "frame refused: routed under a stale ring "
                        "(GEBR); reconnect re-reads the hello"
                    )
                self._conn_lost(exc)
                return
            (fid,) = _U32.unpack_from(data, 8)
            _check_wire_count(n)
            if magic == MAGIC_WFAST_RESP:
                resps = decode_fast_body(data[12:], n)
            elif magic == MAGIC_WRESP:
                resps = decode_string_body(data[12:], n)
            else:
                raise GebError(f"bad response magic {magic:#x}")
        except (GebError, struct.error) as e:
            self._conn_lost(
                e if isinstance(e, GebError) else GebError(str(e))
            )
            return
        fut = self._inflight.pop(fid, None)
        if fut is not None and not fut.done():
            fut.set_result(resps)

    def _on_ring_torn(self, exc: Exception) -> None:
        """The lane died under us (server teardown, drain, protocol
        violation). Frames in flight on the ring are in-doubt — the
        module's at-most-once stance is a connection loss; the next
        call reconnects over the socket and may re-map."""
        if self._lane is None:
            return
        self._conn_lost(exc)

    def _maybe_start_router(self) -> None:
        """Activate per-owner fast routing (r18) when it is provably
        sound: multi-node ring, fast capability, matching hash tiers,
        and a routable frame door for every peer. Records why not,
        otherwise swaps get_rate_limits onto the router."""
        hello = self.hello
        if hello is None or self.mode == "string":
            return
        if len(hello.nodes) <= 1:
            return  # single node: the direct fast path already won
        reason = None
        if not hello.fast:
            reason = "hello capability (no fast path advertised)"
        elif hello.xxh64 != client_hash_is_native():
            reason = "hash mismatch (server/client XXH64 tiers)"
        elif any(
            not is_self and not door
            for is_self, _, door in hello.nodes
        ):
            reason = "peer door unknown (GUBER_GEB_PEER_DOORS unset?)"
        if reason is not None:
            self._downgrades += 1
            self._downgrade_reason = reason
            if not self._downgrade_logged:
                self._downgrade_logged = True
                log.info(
                    "geb client %s: ring routing unavailable — %s; "
                    "staying on string frames (logged once)",
                    self.endpoint,
                    reason,
                )
            return
        self._router = _RingRouter(self, hello)

    def _conn_lost(self, exc: Optional[BaseException]) -> None:
        """Fail everything still in flight and reset so the next call
        reconnects fresh (new hello, new ring)."""
        lane, self._lane = self._lane, None
        if lane is not None:
            lane.close()
        inflight, self._inflight = self._inflight, {}
        self._reader = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        # cancel the reader so a stale loop can't outlive its
        # connection (its own teardown is writer-identity-guarded, so
        # even an uncancellable straggler cannot touch a successor)
        task = self._read_task
        self._read_task = None
        if task is not None and task is not asyncio.current_task():
            task.cancel()
        for fut in inflight.values():
            if not fut.done():
                # only GEBR refusals carry per-frame semantics that
                # hold for EVERY frame in flight (the server refused
                # them all un-served — retry is safe); any other
                # failure, including a decode error on one response,
                # leaves the others' delivery unknown and must surface
                # as the connection-loss type, not the trigger's
                fut.set_exception(
                    exc
                    if isinstance(
                        exc, (GebStaleRingError, GebDrainingError)
                    )
                    else GebConnectionError(
                        f"connection to {self.endpoint} lost with "
                        f"frames in flight ({exc!r}); delivery unknown"
                    )
                )

    async def close(self) -> None:
        self._closed = True
        router, self._router = self._router, None
        if router is not None:
            await router.close()
        task = self._read_task
        self._conn_lost(GebError("client closed"))
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    def stats(self) -> dict:
        """Operator-facing counters (r18 satellite): which transport
        and framing this client actually negotiated, and whether auto
        mode silently downgraded to string frames (and why)."""
        transport = self._kind
        if self._lane is not None:
            transport = "shm"
        return {
            "endpoint": self.endpoint,
            "mode": self.mode,
            "transport": transport,
            "use_fast": self._use_fast,
            "ring_routed": self._router is not None,
            "downgrades": self._downgrades,
            "downgrade_reason": self._downgrade_reason,
            "frames_socket": self._frames_socket,
            "frames_shm": self._frames_shm,
        }

    async def __aenter__(self):
        await self.connect()
        return self

    async def __aexit__(self, *a):
        await self.close()

    # -- request path -------------------------------------------------------

    async def get_rate_limits(
        self,
        reqs: Sequence[RateLimitReq],
        timeout: Optional[float] = None,
        trace=None,
    ) -> List[RateLimitResp]:
        """Serve one batch as one frame. Under concurrency, calls
        pipeline up to the credit window; responses match by frame id
        regardless of completion order.

        `trace` (r16): a serve/tracing.TraceContext to carry in-band
        over the GEBT framing — or, by default, the caller's active
        SAMPLED trace context (serve.tracing, stdlib-only) when the
        server advertises HELLO_TRACE. Fast and chained frames drop
        the context (trace-free by design / no GEBC slot); pre-r16
        servers never see GEBT.

        With ring routing active (r18), fast-eligible items shard per
        owner across per-node connections; the rest ride this
        connection's string frames. Responses return in input order."""
        await self.connect()
        if self._router is not None:
            return await self._router.get_rate_limits(
                reqs, timeout, trace
            )
        return await self._get_direct(reqs, timeout, trace)

    async def _get_direct(
        self,
        reqs: Sequence[RateLimitReq],
        timeout: Optional[float] = None,
        trace=None,
    ) -> List[RateLimitResp]:
        """One batch -> one frame on THIS connection (the pre-r18
        get_rate_limits body; the router calls it per shard)."""
        await self.connect()
        if (
            any(getattr(r, "chain", None) for r in reqs)
            and not self.hello.chain
        ):
            # sending GEBC at a pre-r15 server would poison the
            # connection (bad magic) — refuse client-side instead
            raise GebError(
                "server does not accept quota-chain frames "
                "(no HELLO_CHAIN capability; pre-r15?)"
            )
        trace_ctx = None
        if self.hello.trace and self._windowed:
            if trace is not None:
                trace_ctx = trace
            else:
                from gubernator_tpu_torch.serve import tracing as _tracing

                tr = _tracing.active()
                if tr is not None and tr.sampled:
                    trace_ctx = tr.context()
        if not self._windowed:
            return await self._legacy_roundtrip(reqs, timeout)
        loop = asyncio.get_running_loop()
        fid = self._next_id
        self._next_id = (self._next_id + 1) & 0x7FFFFFFF or 1
        frame, is_fast = build_frame(
            reqs,
            fast=self._use_fast,
            windowed=True,
            frame_id=fid,
            ring_hash=(
                self._ring_hash_override
                if self._ring_hash_override is not None
                else self.hello.ring_hash
            ),
            t_sent_us=int(loop.time() * 1e6),
            trace_ctx=trace_ctx,
        )
        fut = loop.create_future()
        sem = self._sem
        await sem.acquire()
        writer = self._writer
        if writer is None:
            sem.release()
            raise GebConnectionError("connection lost before send")
        self._inflight[fid] = fut
        # shm lane first (r18): False means no room right now or the
        # frame outgrows the ring's bound — that frame (only) falls
        # back to the control socket, same connection, same window
        lane = self._lane
        if lane is not None and lane.try_send(frame):
            self._frames_shm += 1
        else:
            try:
                writer.write(frame)
                await writer.drain()
                self._frames_socket += 1
            except (ConnectionError, OSError) as e:
                self._inflight.pop(fid, None)
                sem.release()
                self._conn_lost(e)
                raise GebConnectionError(
                    f"send to {self.endpoint} failed: {e}"
                ) from e
        try:
            resps = await asyncio.wait_for(
                fut, timeout if timeout is not None else self.timeout
            )
        except asyncio.TimeoutError:
            # the window slot is wedged (frame may still be in service
            # server-side): the connection is no longer accountable —
            # drop it so state can't leak into later calls
            self._conn_lost(
                GebConnectionError("frame timed out; connection reset")
            )
            raise
        finally:
            sem.release()
        if len(resps) != len(reqs):
            raise GebError(
                f"response count {len(resps)} != request {len(reqs)}"
            )
        return resps

    async def _legacy_roundtrip(self, reqs, timeout):
        """Pre-r7 server: one frame in flight per connection
        (GEB1/GEB6 framings, version-skew fallback)."""
        frame, is_fast = build_frame(
            reqs,
            fast=self._use_fast,
            windowed=False,
            ring_hash=self.hello.ring_hash,
        )

        async def roundtrip():
            async with self._legacy_lock:
                writer, reader = self._writer, self._reader
                if writer is None:
                    raise GebConnectionError("connection lost")
                writer.write(frame)
                await writer.drain()
                magic, n = _HDR.unpack(await reader.readexactly(8))
                if magic == MAGIC_STALE:
                    raise GebStaleRingError(
                        "frame refused: stale ring (GEBR)"
                    )
                _check_wire_count(n)
                if is_fast:
                    if magic != MAGIC_FAST_RESP:
                        raise GebError(f"bad response magic {magic:#x}")
                    return decode_fast_body(
                        await reader.readexactly(n * 25), n
                    )
                if magic != MAGIC_RESP:
                    raise GebError(f"bad response magic {magic:#x}")
                return await _read_string_items(reader, n)

        try:
            return await asyncio.wait_for(
                roundtrip(),
                timeout if timeout is not None else self.timeout,
            )
        except (
            GebError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            asyncio.TimeoutError,
        ) as e:
            # ANY failure here leaves the one-frame-in-flight stream
            # unaccountable (response half-read or never read): drop
            # the connection so leftover bytes can't be parsed as the
            # next call's response header
            self._conn_lost(None if isinstance(e, GebError) else e)
            if isinstance(e, (GebError, asyncio.TimeoutError)):
                raise
            raise GebConnectionError(
                f"round trip to {self.endpoint} failed: {e}"
            ) from e

    # -- response reader ----------------------------------------------------

    async def _read_loop(self, reader, writer):
        exc: Optional[BaseException] = None
        try:
            while True:
                magic, n = _HDR.unpack(await reader.readexactly(8))
                if magic == MAGIC_STALE:
                    # GEBR: second word is the refused frame id; every
                    # frame still in flight was refused un-served too
                    # (the server closes the connection behind it)
                    if n == DRAIN_FRAME_ID:
                        exc = GebDrainingError(
                            f"{self.endpoint} is draining; frame not "
                            f"served (safe to retry elsewhere)"
                        )
                    else:
                        exc = GebStaleRingError(
                            "frame refused: routed under a stale ring "
                            "(GEBR); reconnect re-reads the hello"
                        )
                    return
                (fid,) = _U32.unpack(await reader.readexactly(4))
                _check_wire_count(n)
                if magic == MAGIC_WFAST_RESP:
                    resps = decode_fast_body(
                        await reader.readexactly(n * 25), n
                    )
                elif magic == MAGIC_WRESP:
                    resps = await _read_string_items(reader, n)
                else:
                    raise GebError(f"bad response magic {magic:#x}")
                fut = self._inflight.pop(fid, None)
                if fut is not None and not fut.done():
                    fut.set_result(resps)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
        ) as e:
            exc = e
        except asyncio.CancelledError:
            return
        except Exception as e:  # protocol desync
            exc = e
        finally:
            # identity guard: only tear down the connection THIS loop
            # was reading. After a timeout/reconnect, self._writer is
            # a successor connection with its own loop and in-flight
            # table — a stale loop's exit must not fail it.
            if self._writer is writer or self._writer is None:
                if self._lane is not None and self._inflight:
                    # the socket EOF raced the lane: frames already
                    # PUBLISHED to the ring (responses, or the GEBR
                    # that explains this close) are ordered on the
                    # ring but not against the socket — bounded grace
                    # for the lane to deliver them before declaring
                    # delivery unknown (a ring GEBR lands its own
                    # _conn_lost with the refusal semantics)
                    loop = asyncio.get_running_loop()
                    deadline = loop.time() + 1.0
                    try:
                        while (
                            self._lane is not None
                            and self._inflight
                            and loop.time() < deadline
                        ):
                            await asyncio.sleep(0.005)
                    except asyncio.CancelledError:
                        pass
                if self._writer is writer or self._writer is None:
                    self._conn_lost(exc)


async def _read_string_items(reader, n: int) -> List[RateLimitResp]:
    out = []
    for _ in range(n):
        st, limit, rem, reset = _RESP_FIX.unpack(
            await reader.readexactly(_RESP_FIX.size)
        )
        (elen,) = _U16.unpack(await reader.readexactly(2))
        err = (await reader.readexactly(elen)).decode()
        (olen,) = _U16.unpack(await reader.readexactly(2))
        owner = (await reader.readexactly(olen)).decode()
        out.append(_string_resp(st, limit, rem, reset, err, owner))
    return out


# -- client-side per-owner fast routing (r18) -------------------------------


def _ring_point(key: str) -> int:
    """crc32 ring point, byte-identical to core.hashing.ring_hash /
    reference hash.go:40-42 (duplicated: this module loads no torch)."""
    return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF


async def _fetch_hello(kind: str, addr) -> Hello:
    """Read one fresh hello over a throwaway connection (GEBR healing:
    the PRIMARY connection stays up while the ring view refreshes)."""
    if kind == "unix":
        reader, writer = await asyncio.open_unix_connection(addr)
    else:
        host, port = addr
        reader, writer = await asyncio.open_connection(host, port)
    try:
        return await read_hello(reader)
    finally:
        writer.close()


class _RingRouter:
    """Shards fast-eligible items per owner across per-node GEB
    connections — the compiled edge's routing, client-side.

    The table is the picker's ring exactly (crc32 point per grpc
    address, sorted, binary-search successor with wraparound on the
    item's `name_key`), built from the hello's membership rows; each
    node's frame door comes from the same rows (self = the primary
    endpoint, peers = their advertised door). Every child connection
    echoes the ROUTER's membership fingerprint — the hello this table
    was built from, NOT the child's own fresher hello — so a server
    whose ring moved refuses with GEBR instead of silently serving a
    mis-routed frame. A GEBR refusal re-fetches the hello over a
    throwaway connection, rebuilds the table, and retries the REFUSED
    shards only (refused = un-served, so the retry is safe), bounded
    at MAX_ATTEMPTS. Connection losses propagate (at-most-once).
    Items fast framing cannot carry (GLOBAL/NO_BATCHING, empty
    name/key, chains) ride the primary connection's string frames."""

    MAX_ATTEMPTS = 3

    def __init__(self, owner: "AsyncGebClient", hello: Hello):
        self._owner = owner
        self._children: Dict[str, AsyncGebClient] = {}
        self._points: List[int] = []
        self._hosts: List[str] = []
        self._endpoints: Dict[str, str] = {}
        self._ring_hash = 0
        self.refreshes = 0
        stale = self._install(hello)
        assert not stale  # no children exist yet

    def _install(self, hello: Hello) -> List["AsyncGebClient"]:
        """(Re)build the table from a hello; returns the children the
        new membership obsoletes (the caller closes them — this method
        stays synchronous)."""
        endpoints: Dict[str, str] = {}
        points: List[Tuple[int, str]] = []
        for is_self, grpc_addr, door in hello.nodes:
            if is_self:
                endpoints[grpc_addr] = self._owner.endpoint
            elif door:
                endpoints[grpc_addr] = door
            else:
                raise GebError(
                    f"ring node {grpc_addr} advertises no frame door; "
                    f"cannot route (GUBER_GEB_PEER_DOORS unset?)"
                )
            points.append((_ring_point(grpc_addr), grpc_addr))
        points.sort()
        if len({p for p, _ in points}) != len(points):
            # mirror of the picker's collision refusal: placement
            # would silently diverge between this table and the ring
            raise GebError("ring point collision between peer addresses")
        self._points = [p for p, _ in points]
        self._hosts = [h for _, h in points]
        self._ring_hash = hello.ring_hash
        stale = []
        for host, child in list(self._children.items()):
            if endpoints.get(host) != child.endpoint:
                stale.append(self._children.pop(host))
            else:
                child._ring_hash_override = self._ring_hash
        self._endpoints = endpoints
        return stale

    def _child(self, host: str) -> "AsyncGebClient":
        child = self._children.get(host)
        if child is None:
            child = AsyncGebClient(
                self._endpoints[host],
                window=self._owner._want_window,
                mode="fast",
                timeout=self._owner.timeout,
                shm=self._owner.shm if self._owner.shm != "require"
                else "auto",
                ring_route=False,
            )
            child._ring_hash_override = self._ring_hash
            self._children[host] = child
        return child

    def owner_of(self, key: str) -> str:
        point = _ring_point(key)
        i = bisect.bisect_left(self._points, point)
        if i == len(self._points):
            i = 0
        return self._hosts[i]

    async def _refresh(self) -> None:
        hello = await _fetch_hello(
            self._owner._kind, self._owner._addr
        )
        stale = self._install(hello)
        self.refreshes += 1
        for child in stale:
            try:
                await child.close()
            except Exception:
                pass

    async def get_rate_limits(
        self,
        reqs: Sequence[RateLimitReq],
        timeout: Optional[float] = None,
        trace=None,
    ) -> List[RateLimitResp]:
        if not reqs:
            # parity with the direct path's empty-batch refusal
            return await self._owner._get_direct(reqs, timeout, trace)
        results: List[Optional[RateLimitResp]] = [None] * len(reqs)
        fast_items: List[Tuple[int, RateLimitReq]] = []
        string_items: List[Tuple[int, RateLimitReq]] = []
        for i, r in enumerate(reqs):
            (fast_items if _fast_eligible_item(r) else
             string_items).append((i, r))

        async def run_string() -> None:
            resps = await self._owner._get_direct(
                [r for _, r in string_items], timeout, trace
            )
            for (i, _), resp in zip(string_items, resps):
                results[i] = resp

        string_task = (
            asyncio.ensure_future(run_string())
            if string_items
            else None
        )
        try:
            pending = fast_items
            last_refusal: Optional[GebError] = None
            for _attempt in range(self.MAX_ATTEMPTS):
                if not pending:
                    break
                groups: Dict[str, List[Tuple[int, RateLimitReq]]] = {}
                for i, r in pending:
                    groups.setdefault(
                        self.owner_of(r.hash_key()), []
                    ).append((i, r))
                hosts = list(groups)
                outs = await asyncio.gather(
                    *[
                        self._child(h)._get_direct(
                            [r for _, r in groups[h]], timeout
                        )
                        for h in hosts
                    ],
                    return_exceptions=True,
                )
                refused: List[Tuple[int, RateLimitReq]] = []
                hard: Optional[BaseException] = None
                for host, out in zip(hosts, outs):
                    if isinstance(
                        out, (GebStaleRingError, GebDrainingError)
                    ):
                        # refused = NOT served; retrying (against a
                        # refreshed ring) is safe by the GEBR contract
                        refused.extend(groups[host])
                        last_refusal = out
                    elif isinstance(out, BaseException):
                        hard = out  # delivery unknown: propagate
                    else:
                        for (i, _), resp in zip(groups[host], out):
                            results[i] = resp
                if hard is not None:
                    raise hard
                pending = refused
                if pending:
                    await self._refresh()
            if pending:
                raise last_refusal or GebError(
                    "ring routing exhausted retries"
                )
        except BaseException:
            if string_task is not None:
                string_task.cancel()
                await asyncio.gather(
                    string_task, return_exceptions=True
                )
            raise
        if string_task is not None:
            await string_task
        return results  # type: ignore[return-value]

    async def close(self) -> None:
        children, self._children = self._children, {}
        for child in children.values():
            try:
                await child.close()
            except Exception:
                pass


# -- sync client ------------------------------------------------------------


class GebClient:
    """Blocking GEB client: the async client on a dedicated event-loop
    thread, so `get_rate_limits` is a plain call (the V1Client shape)
    while the connection underneath still pipelines — concurrent calls
    from several threads share the credit window."""

    def __init__(
        self,
        endpoint: str,
        window: int = 0,
        mode: str = "auto",
        timeout: Optional[float] = 30.0,
        shm: str = "auto",
        ring_route: Optional[bool] = None,
    ):
        self._client = AsyncGebClient(
            endpoint,
            window=window,
            mode=mode,
            timeout=timeout,
            shm=shm,
            ring_route=ring_route,
        )
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever,
            name="guber-geb-client",
            daemon=True,
        )
        self._thread.start()

    def _run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()
            raise

    def connect(self) -> Hello:
        return self._run(self._client.connect())

    @property
    def hello(self) -> Optional[Hello]:
        return self._client.hello

    def stats(self) -> dict:
        return self._client.stats()

    def get_rate_limits(
        self,
        reqs: Sequence[RateLimitReq],
        timeout: Optional[float] = None,
    ) -> List[RateLimitResp]:
        return self._run(self._client.get_rate_limits(reqs, timeout))

    def get_rate_limits_pipelined(
        self, batches: Sequence[Sequence[RateLimitReq]]
    ) -> List[List[RateLimitResp]]:
        """Serve many batches as concurrently pipelined frames (up to
        the credit window in flight); results in input order."""

        async def run_all():
            return await asyncio.gather(
                *[self._client.get_rate_limits(b) for b in batches]
            )

        return self._run(run_all())

    def close(self) -> None:
        try:
            self._run(self._client.close(), timeout=5.0)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5.0)
            self._loop.close()

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *a):
        self.close()


# -- HTTP binary door -------------------------------------------------------


class AsyncHttpGebClient:
    """Binary GEB frames over the HTTP gateway (POST /v1/geb,
    content-type gated) for clients behind HTTP-only infrastructure:
    no protobuf, no JSON — one legacy-framed GEB payload per request
    body. GET /v1/geb returns the hello (ring + capability flags), so
    fast framing negotiates exactly like the socket client; a GEBR
    body heals by re-reading the hello and retrying once."""

    def __init__(
        self, base_url: str, mode: str = "auto", timeout: float = 30.0
    ):
        if mode not in ("auto", "fast", "string"):
            raise ValueError("mode must be 'auto', 'fast', or 'string'")
        self.base_url = base_url.rstrip("/")
        self.mode = mode
        self.timeout = timeout
        self.hello: Optional[Hello] = None
        self._use_fast = False
        self._session = None

    async def _ensure(self) -> None:
        if self._session is None:
            import aiohttp  # lazy: server-side dep, not a client one

            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout)
            )
        if self.hello is None:
            async with self._session.get(
                self.base_url + GEB_HTTP_PATH
            ) as resp:
                if resp.status != 200:
                    raise GebError(
                        f"GET {GEB_HTTP_PATH} -> {resp.status} (no "
                        f"binary door on this gateway?)"
                    )
                hello = parse_hello_bytes(await resp.read())
            self.hello = hello
            if self.mode == "string":
                self._use_fast = False
            elif self.mode == "fast":
                if not hello.fast:
                    raise GebError(
                        "mode='fast' but the gateway does not "
                        "advertise the fast path"
                    )
                self._use_fast = True
            else:
                self._use_fast = (
                    hello.fast
                    and hello.xxh64 == client_hash_is_native()
                    and len(hello.nodes) <= 1
                )

    async def get_rate_limits(
        self, reqs: Sequence[RateLimitReq], _retried: bool = False
    ) -> List[RateLimitResp]:
        await self._ensure()
        chained = any(getattr(r, "chain", None) for r in reqs)
        if chained and not self.hello.chain:
            raise GebError(
                "gateway does not accept quota-chain frames "
                "(no HELLO_CHAIN capability; pre-r15?)"
            )
        # chains need the GEBC framing, which is windowed-shaped; the
        # gateway echoes the frame id without pipelining semantics
        frame, is_fast = build_frame(
            reqs,
            fast=self._use_fast,
            windowed=chained,
            ring_hash=self.hello.ring_hash,
        )
        async with self._session.post(
            self.base_url + GEB_HTTP_PATH,
            data=frame,
            headers={"Content-Type": GEB_CONTENT_TYPE},
        ) as resp:
            if resp.status != 200:
                raise GebError(
                    f"POST {GEB_HTTP_PATH} -> {resp.status}: "
                    f"{(await resp.read())[:200]!r}"
                )
            body = await resp.read()
        if len(body) < _HDR.size:
            # a truncating proxy or empty 200 body stays inside the
            # module's GebError contract, not a raw struct.error
            raise GebError(
                f"short response frame ({len(body)} bytes)"
            )
        magic, n = _HDR.unpack_from(body, 0)
        if magic == MAGIC_STALE:
            if n == DRAIN_FRAME_ID:
                raise GebDrainingError("gateway draining; frame not served")
            if _retried:
                raise GebStaleRingError("stale ring after hello refresh")
            self.hello = None  # re-read the ring, retry once
            return await self.get_rate_limits(reqs, _retried=True)
        if is_fast:
            if magic != MAGIC_FAST_RESP:
                raise GebError(f"bad response magic {magic:#x}")
            out = decode_fast_body(body[8:], n)
        elif chained:
            # GEBC is answered with a GEB4 frame: u32 frame_id (echoed,
            # meaningless over HTTP) precedes the items
            if magic != MAGIC_WRESP:
                raise GebError(f"bad response magic {magic:#x}")
            out = decode_string_body(body[12:], n)
        else:
            if magic != MAGIC_RESP:
                raise GebError(f"bad response magic {magic:#x}")
            out = decode_string_body(body[8:], n)
        if len(out) != len(reqs):
            # positional pairing downstream: a truncating proxy or
            # miscounting server must fail loudly, never misattribute
            raise GebError(
                f"response count {len(out)} != request {len(reqs)}"
            )
        return out

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def __aenter__(self):
        await self._ensure()
        return self

    async def __aexit__(self, *a):
        await self.close()
