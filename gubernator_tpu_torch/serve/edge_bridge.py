"""Backend bridge for the native serving edge (native/edge/edge.cc).

The port's copy of gubernator_tpu/serve/edge_bridge.py with its imports
rewritten; the file references below are the reference package's. Its
hello differs from the reference's in two bits, and only there:

- HELLO_FAST (bit 0) on the edge bridge follows the slot hash. The
  store hashes XXH64 when the port's native hasher loads
  (native/guberhash.cc, core.hashing.slot_hash_is_xxh64), as the
  reference's does; then every door offers HELLO_FAST with HELLO_XXH64,
  as the reference's doors do. When it does not load, the store hashes
  blake2b-8: the GEB door and POST /v1/geb still offer HELLO_FAST
  (without HELLO_XXH64, which a blake2b client matches), but the edge
  bridge withholds it (EdgeBridge._fast_ok), because the compiled edge
  always pre-hashes XXH64 and reads bit 0 alone: a fast edge frame
  would count a key in a second row. The edge's items then ride string
  frames, which the string fold below puts on the array path, hashed
  here.
- HELLO_CHAIN (bit 3) is never offered: quota chains are not ported. A
  GEBC frame that arrives anyway decodes, and each chained item gets
  the instance's per-item "not ported" answer.

Everything below the hello (framings, fold, shed screen, stage clock,
drain and stale-ring refusals) is the reference's. Pre-hashed frames
decide through DeviceBatcher.decide_arrays on the port's TorchBackend.

The C++ edge terminates client HTTP/JSON connections and coalesces
requests into batches; each batch crosses into Python as ONE compact
binary frame over a unix-domain socket, so the Python process pays one
read + one decode per BATCH instead of per request — the per-request
Python HTTP/JSON overhead (the serving tier's real bottleneck) stays in
C++. The decisions still flow through the full serving Instance
(validation, ring ownership, forwarding, GLOBAL replica handling), so
edge-fronted and directly-connected clients see identical semantics.

Cluster topology (r5): the bridge also listens on TCP
(GUBER_EDGE_TCP) so that an edge fronting a multi-node cluster can
ship each pre-hashed frame DIRECTLY to the key's ring owner — the
compiled-front-door-as-cluster-node shape of the reference, where
every compiled server computes ring ownership itself (reference
gubernator.go:114, hash.go:80-96). The hello carries the live ring
(peer gRPC addresses + bridge endpoints + which one is this node);
fast frames echo a fingerprint of the membership they were routed
with, and a frame routed under a stale view is refused with a GEBR
frame so the edge re-reads the ring — never silently mis-admitted.

Windowed pipelining (r7): the r5 protocol allowed ONE frame in flight
per connection, so every frame paid a full bridge round trip before
the next could even be decoded — the edge's decode/encode serialized
against the daemon's device wait, and the served rate was capped at
(frames/connection-RTT) x connections. The hello now advertises a
credit window W (flags bit 1 + high 16 bits); a windowed edge keeps up
to W frames outstanding per connection, each carrying a frame id, and
the bridge serves them CONCURRENTLY — responses complete out of order
and are matched by id. Frames from all connections co-batch in the
device batcher's queue (deep rungs under load), and edge-side
decode/encode of frame N+1 overlaps the device wait of frame N.
Exceeding the window is backpressured, not policed: the bridge stops
reading the connection until a slot frees, so TCP flow control pushes
back to the edge (which also respects the advertised credit itself).

Frame protocol (little-endian, lengths in bytes):

  hello (bridge->edge, on connect):
                   u32 magic 'GEBI' | u32 flags | u32 ring_hash |
                   u32 n_nodes | n_nodes x node
      node: u8 is_self | u16 grpc_len | grpc_addr |
            u16 bridge_len | bridge_addr
      flags bit 0: pre-hashed fast path available (array backend).
      flags bit 1: windowed frames accepted (GEB2/GEB7); the credit
      window (max frames in flight per connection) is flags >> 16.
      ring_hash = crc32 of "\n".join(sorted(grpc addresses)) — the
      membership fingerprint fast frames must echo. bridge_addr is
      where an edge reaches THAT node's bridge ("host:port",
      IPv4/hostname only — IPv6 specs are refused at config time);
      empty for this node (the edge uses its configured --backend) and
      for peers when GUBER_EDGE_TCP is unset (the edge then routes
      those items through the string path).
  request frame:   u32 magic 'GEB1' | u32 n | u32 payload_len |
                   payload = n x item
      item: u16 name_len | name | u16 key_len | key |
            i64 hits | i64 limit | i64 duration | u8 algorithm |
            u8 behavior
  response frame:  u32 magic 'GEB3' | u32 n | n x item
      item: u8 status | i64 limit | i64 remaining | i64 reset_time |
            u16 error_len | error | u16 owner_len | owner
      (owner = metadata["owner"] for forwarded keys, empty otherwise)
  fast request:    u32 magic 'GEB6' | u32 n | u32 ring_hash |
                   u32 payload_len | payload = n x 33-byte record
  fast response:   u32 magic 'GEB5' | u32 n | n x 25-byte record
  windowed string request (r7):
                   u32 magic 'GEB2' | u32 n | u32 frame_id |
                   u64 t_sent_us | u32 payload_len | payload
      (items as GEB1; t_sent_us = sender's CLOCK_MONOTONIC stamp in
      microseconds, 0 = unstamped — the bridge attributes the
      edge->bridge transit stage from it, calibrated per connection
      against the smallest delta seen so a remote edge's different
      monotonic epoch self-cancels; serve/stages.py)
  windowed string response (r7):
                   u32 magic 'GEB4' | u32 n | u32 frame_id |
                   items as GEB3
  windowed chain request (r15):
                   u32 magic 'GEBC' | u32 n | u32 frame_id |
                   u64 t_sent_us | u32 payload_len | payload
      item: as GEB1 item | u8 n_levels | n_levels x level
      level: u16 key_len | key | i64 limit | i64 duration
      (hierarchical quota chains; answered with a plain GEB4 frame —
      the chain collapses most-restrictive-wins server-side)
  windowed traced string request (r16):
                   u32 magic 'GEBT' | u32 n | u32 frame_id |
                   u64 t_sent_us | 16B trace_id (big-endian) |
                   u64 span_id | u8 trace_flags | u32 payload_len |
                   payload (items as GEB1)
      The distributed-tracing extension behind the HELLO_TRACE
      capability bit: the frame carries its originating W3C-style
      trace context (trace_flags bit 0 = sampled) and is answered
      with a plain GEB4 frame. Legacy peers never see GEBT (the
      client gates on the hello bit); fast 33-byte records stay
      trace-free by design — fast frames are head-sampled
      bridge-side instead (GUBER_TRACE_SAMPLE).
  windowed fast request (r7):
                   u32 magic 'GEB7' | u32 n | u32 frame_id |
                   u32 ring_hash | u64 t_sent_us | u32 payload_len |
                   payload = n x 33-byte record
  windowed fast response (r7):
                   u32 magic 'GEB8' | u32 n | u32 frame_id |
                   n x 25-byte record
  stale ring:      u32 magic 'GEBR' | u32 frame_id (0 pre-r7)
                   (then the bridge closes; the edge fails every frame
                   still in flight on the connection as stale,
                   re-reads the hello, re-routes)
      frame_id 0xFFFFFFFF is the DRAIN code (r8): the node is shutting
      down gracefully — frames already accepted on the connection have
      been answered (the bridge waits for them BEFORE sending the
      refusal), this one was not served, and reconnecting is pointless
      (the listener is closed). An edge that predates the code treats
      it as a stale-ring refusal: it fails the refused frame for
      re-route and finds the node gone on reconnect — degraded, not
      broken. Sent on the windowed (GEB2/GEB7) and legacy fast (GEB6)
      framings, whose readers understand GEBR; a legacy STRING frame
      (GEB1) predates GEBR entirely and is drain-refused with a
      well-formed GEB3 response carrying per-item "node draining"
      errors instead.

Over-limit shedding (r10): before a decoded frame's items enqueue
toward the device, they are screened against the instance's over-limit
shed cache (serve/shedcache.py) — frozen token-bucket refusals answer
at the bridge, the residue rides the batcher, and the responses stitch
back in frame order. Applies to the pre-hashed framings (GEB6/GEB7)
and the string fold alike; object-path string items get the same
treatment inside Instance.get_rate_limits.

Non-windowed frames (GEB1/GEB6) keep their one-in-flight round-trip
semantics for version-skewed edges; a bridge serves both framings on
the same connection. Malformed input closes the connection.

Trust boundary: like the PeersV1 gRPC service (which applies whatever
batch a forwarding peer sends without re-checking ownership, reference
gubernator.go:210-227), the bridge trusts a fast frame whose ring
fingerprint matches — both are internal cluster ports and must not be
exposed to clients.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
import zlib
from typing import List, Optional

from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.core.hashing import slot_hash_batch, slot_hash_is_xxh64
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.config import MAX_BATCH_SIZE
from gubernator_tpu_torch.serve.faults import FAULTS
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.edge")

MAGIC_REQ = 0x31424547  # 'GEB1' little-endian
MAGIC_RESP = 0x33424547  # 'GEB3' (owner field added r3)
MAGIC_HELLO = 0x49424547  # 'GEBI' — ring-carrying hello (r5; was GEBH)
MAGIC_FAST_REQ = 0x36424547  # 'GEB6' — pre-hashed items + ring hash (r5)
MAGIC_FAST_RESP = 0x35424547  # 'GEB5'
MAGIC_STALE = 0x52424547  # 'GEBR' — fast frame refused: stale ring
MAGIC_WREQ = 0x32424547  # 'GEB2' — windowed string request (r7)
MAGIC_WRESP = 0x34424547  # 'GEB4' — windowed string response (r7)
MAGIC_WFAST_REQ = 0x37424547  # 'GEB7' — windowed pre-hashed request (r7)
MAGIC_WFAST_RESP = 0x38424547  # 'GEB8' — windowed pre-hashed response
MAGIC_WTRACE = 0x54424547  # 'GEBT' — windowed trace-extended string
# request (r16): header as GEB2 plus the originating trace context
# (16-byte big-endian trace id, u64 span id, u8 flags; bit 0 =
# sampled). Answered with a plain GEB4 frame. String framing only —
# the 33-byte fast records have no room, so fast frames are sampled
# bridge-side instead (module docstring).
MAGIC_WCHAIN = 0x43424547  # 'GEBC' — windowed chain-extended string
# request (r15): header as GEB2; items as GEB1 plus a u8 level count
# and that many (u16 key_len | key | i64 limit | i64 duration) chain
# levels. Responses come back as plain GEB4 (the chain collapses
# most-restrictive-wins server-side). String framing only: the 33-byte
# fast records have no varlen room — a chained item is never
# fast-eligible (documented scope limit, client_geb._fast_eligible).

HELLO_FAST = 1  # hello flags bit 0
HELLO_WINDOWED = 2  # hello flags bit 1; window size = flags >> 16
# hello flags bit 2 (r12): this node's slot store hashes with the
# native XXH64 hasher. A PRE-hashing client (GEB7 fast frames) must run
# the SAME hash implementation as the store or its keys silently land
# in different rows than the string path's; the bit lets the client
# verify agreement at hello time (client_geb.py auto mode) instead of
# splitting buckets. Pre-r12 edges ignore unknown bits (the compiled
# edge always hashes XXH64, so the port's edge bridge offers it fast
# frames only on an XXH64 store: EdgeBridge._fast_ok).
HELLO_XXH64 = 4
# hello flags bit 3 (r15): this bridge accepts GEBC chain-extended
# string frames (hierarchical quota chains). The compiled edge's JSON
# door does not speak chains — chained callers use the GEB client or
# the daemon's HTTP/gRPC doors (documented scope limit).
HELLO_CHAIN = 8
# hello flags bit 4 (r16): this bridge accepts GEBT trace-extended
# string frames (distributed tracing context, serve/tracing.py). A
# capability of the PROTOCOL version, advertised unconditionally —
# whether a carried context is acted on is the receiving node's
# GUBER_TRACE_* policy (honored only while tracing is enabled at all;
# a node with tracing off ignores carried contexts, Tracer.join).
# Legacy peers negotiate it off by ignoring unknown bits and never
# emitting GEBT.
HELLO_TRACE = 16
# hello flags bit 5 (r18): this CONNECTION may negotiate the
# shared-memory GEB lane (serve/shm.py) with a GEBM request — set only
# on unix-socket connections of an shm-enabled service, because the
# lane maps a same-host file (re-exported from serve.shm, the owner).
from gubernator_tpu_torch.serve.shm import (  # noqa: E402
    HELLO_SHM,
    MAGIC_SHM_OK,
    MAGIC_SHM_REQ,
)

DEFAULT_WINDOW = 32
MAX_WINDOW = 1024

#: GEBR frame_id meaning "draining, not stale ring" (r8): real frame
#: ids are sequence numbers far below this; legacy edges treat it as a
#: stale-ring refusal (safe: re-route, reconnect fails)
DRAIN_FRAME_ID = 0xFFFFFFFF

#: hard cap on one frame's u32 payload length on the CLIENT-facing
#: doors (GebListener, POST /v1/geb). The wire's plen is untrusted
#: there: without this bound an unauthenticated connection could
#: advertise a ~4 GiB payload and stream it into server memory before
#: any validation runs. 8 MiB covers every frame the packaged client
#: can legally build (its 65536-item bound is ~2.1 MiB of fast
#: records; only very long names/keys approach the byte bound, which
#: it enforces too) and is mirrored (test-pinned) in client_geb.py,
#: which refuses oversized frames client-side before they hit the wire.
MAX_FRAME_PAYLOAD = 8 << 20

#: the trusted edge->bridge door's default cap (GUBER_EDGE_MAX_FRAME_MIB
#: to widen). The compiled edge chunks at --batch-limit items but has
#: no byte bound and no split logic, and its items may legally carry
#: u16-length names/keys — a 1000-item batch of ~10 KB keys is a
#: legitimate >8 MiB frame that must keep flowing. 256 MiB clears the
#: theoretical max legal frame at the default batch limit
#: (1000 x ~131 KB) while still refusing a lying ~4 GiB header
#: outright.
EDGE_MAX_FRAME_PAYLOAD = 256 << 20


def bound_payload_len(plen: int, cap: int = MAX_FRAME_PAYLOAD) -> int:
    """Validate an untrusted wire payload length BEFORE buffering it;
    raises ValueError (= close the connection / 400 the request) on an
    oversized frame."""
    if plen > cap:
        raise ValueError(
            f"frame payload of {plen} bytes exceeds the "
            f"{cap}-byte bound"
        )
    return plen


def ring_fingerprint(hosts) -> int:
    """crc32 fingerprint of a membership set. Covers only the gRPC
    addresses (the ring points, core/hashing.ring_hash): two nodes with
    the same membership agree on this even when they derive different
    bridge endpoints, and a bridge-endpoint misconfiguration can only
    cause connection errors, never silent mis-ownership."""
    return zlib.crc32("\n".join(sorted(hosts)).encode()) & 0xFFFFFFFF


# endpoint parsing is the shared gubernator_tpu_torch.endpoints helper
# (r12): the client tier (client.py / client_geb.py) applies the same
# loud IPv6 refusal
from gubernator_tpu_torch.endpoints import reject_ipv6_endpoint  # noqa: E402


_HDR = struct.Struct("<II")
_ITEM_FIX = struct.Struct("<qqqBB")
_RESP_FIX = struct.Struct("<Bqqq")
_WFAST_HDR = struct.Struct("<IIQ")  # frame_id | ring_hash | t_sent_us
_WREQ_HDR = struct.Struct("<IQ")  # frame_id | t_sent_us
# GEBT trace extension, read after _WREQ_HDR (r16):
# trace_id (16 bytes, big-endian) | span_id | flags (bit 0 = sampled)
_WTRACE_EXT = struct.Struct("<16sQB")

# GEB6 record: the edge pre-hashes name+"_"+key with the SAME XXH64 the
# daemon's slot store uses when the native hasher loads (edge.cc xxh64
# vs native/guberhash.cc, pinned by tests; on a blake2b-8 store the edge
# gets no fast frames), so the daemon's fast path never touches per-item
# Python: np.frombuffer views the whole frame as a structured array.
_FAST_REQ_DTYPE = None
_FAST_RESP_DTYPE = None

# GEB3/GEB4 response record for an all-folded string frame: the 25-byte
# fixed decision plus the two zero-length varlen fields (error, owner)
# as literal u16 zeros — one numpy tobytes() instead of n encode-loop
# turns. The edge stamps the routed owner itself on per-owner slow
# shards (edge.cc fill_string_decisions), so empty owner here keeps
# parity with a locally-served item on the object path.
_STRING_RESP_DTYPE = None


def _string_resp_dtype():
    global _STRING_RESP_DTYPE
    if _STRING_RESP_DTYPE is None:
        import numpy as np

        _STRING_RESP_DTYPE = np.dtype(
            [
                ("status", "u1"),
                ("limit", "<i8"),
                ("remaining", "<i8"),
                ("reset_time", "<i8"),
                ("elen", "<u2"),
                ("olen", "<u2"),
            ]
        )
    return _STRING_RESP_DTYPE


def _fast_dtypes():
    global _FAST_REQ_DTYPE, _FAST_RESP_DTYPE
    if _FAST_REQ_DTYPE is None:
        import numpy as np

        _FAST_REQ_DTYPE = np.dtype(
            [
                ("key_hash", "<u8"),
                ("hits", "<i8"),
                ("limit", "<i8"),
                ("duration", "<i8"),
                ("algo", "u1"),
            ]
        )
        _FAST_RESP_DTYPE = np.dtype(
            [
                ("status", "u1"),
                ("limit", "<i8"),
                ("remaining", "<i8"),
                ("reset_time", "<i8"),
            ]
        )
    return _FAST_REQ_DTYPE, _FAST_RESP_DTYPE


def _trace_ctx_from_ext(raw_tid: bytes, span_id: int, flags: int):
    """GEBT extension fields -> TraceContext (None for a zero id —
    degrade to untraced, never error, like a malformed traceparent)."""
    tid = int.from_bytes(raw_tid, "big")
    if tid == 0 or span_id == 0:
        return None
    return tracing.TraceContext(tid, span_id, bool(flags & 1))


def decode_request_frame(
    payload: bytes, n: int
) -> List[Optional[RateLimitReq]]:
    """Decode one edge frame. An item whose name/unique_key bytes are not
    valid UTF-8 decodes to None — the bridge answers it with a per-item
    error; the edge's minimal JSON parser passes raw bytes through, and
    one client's garbage must not poison the co-batched requests of
    OTHER connections by failing the whole frame."""
    items: List[Optional[RateLimitReq]] = []
    off = 0
    for _ in range(n):
        (name_len,) = struct.unpack_from("<H", payload, off)
        off += 2
        raw_name = payload[off : off + name_len]
        off += name_len
        (key_len,) = struct.unpack_from("<H", payload, off)
        off += 2
        raw_key = payload[off : off + key_len]
        off += key_len
        hits, limit, duration, algo, behavior = _ITEM_FIX.unpack_from(
            payload, off
        )
        off += _ITEM_FIX.size
        try:
            name = raw_name.decode()
            key = raw_key.decode()
        except UnicodeDecodeError:
            items.append(None)
            continue
        # clamp unknown enum bytes to the default, matching the daemon's
        # JSON gateway (server._enum_val) — one bad client item must not
        # poison the co-batched requests of other connections
        items.append(
            RateLimitReq(
                name=name,
                unique_key=key,
                hits=hits,
                limit=limit,
                duration=duration,
                algorithm=Algorithm(algo) if 0 <= algo <= 3
                else Algorithm.TOKEN_BUCKET,
                behavior=Behavior(behavior) if behavior in (0, 1, 2)
                else Behavior.BATCHING,
            )
        )
    if off != len(payload):
        raise ValueError("trailing bytes in request frame")
    return items


def decode_chain_request_frame(
    payload: bytes, n: int
) -> List[Optional[RateLimitReq]]:
    """Decode one GEBC chain-extended string frame (r15): each item is
    a GEB1 item plus a u8 level count and that many
    (u16 key_len | key | i64 limit | i64 duration) ancestor levels,
    shallow to deep. Non-UTF-8 item bytes decode to None exactly like
    decode_request_frame; the port's Instance answers each chained item
    with its per-item CHAINS_NOT_PORTED error."""
    from gubernator_tpu_torch.api.types import ChainLevel

    items: List[Optional[RateLimitReq]] = []
    off = 0
    for _ in range(n):
        (name_len,) = struct.unpack_from("<H", payload, off)
        off += 2
        raw_name = payload[off : off + name_len]
        off += name_len
        (key_len,) = struct.unpack_from("<H", payload, off)
        off += 2
        raw_key = payload[off : off + key_len]
        off += key_len
        hits, limit, duration, algo, behavior = _ITEM_FIX.unpack_from(
            payload, off
        )
        off += _ITEM_FIX.size
        (n_levels,) = struct.unpack_from("<B", payload, off)
        off += 1
        raw_levels = []
        for _lv in range(n_levels):
            (lk_len,) = struct.unpack_from("<H", payload, off)
            off += 2
            raw_lk = payload[off : off + lk_len]
            off += lk_len
            lv_limit, lv_duration = struct.unpack_from("<qq", payload, off)
            off += 16
            raw_levels.append((raw_lk, lv_limit, lv_duration))
        try:
            name = raw_name.decode()
            key = raw_key.decode()
            chain = [
                ChainLevel(
                    unique_key=raw_lk.decode(), limit=li, duration=d
                )
                for raw_lk, li, d in raw_levels
            ]
        except UnicodeDecodeError:
            items.append(None)
            continue
        items.append(
            RateLimitReq(
                name=name,
                unique_key=key,
                hits=hits,
                limit=limit,
                duration=duration,
                algorithm=Algorithm(algo) if 0 <= algo <= 3
                else Algorithm.TOKEN_BUCKET,
                behavior=Behavior(behavior) if behavior in (0, 1, 2)
                else Behavior.BATCHING,
                chain=chain,
            )
        )
    if off != len(payload):
        raise ValueError("trailing bytes in chain request frame")
    return items


def encode_response_frame(resps, magic=MAGIC_RESP, frame_id=None) -> bytes:
    hdr = _HDR.pack(magic, len(resps))
    if frame_id is not None:  # windowed (GEB4) framing
        hdr += struct.pack("<I", frame_id)
    # vectorized encode (r9): when no response carries an error or a
    # forwarded-owner tag — the overwhelmingly common locally-served
    # frame — every item is the 25-byte fixed decision plus two zero
    # u16 length prefixes, i.e. exactly one _STRING_RESP_DTYPE record.
    # Four numpy column fills + one tobytes() replace n struct.pack
    # calls and 5n list appends; the per-item loop below remains for
    # frames carrying errors/owners (varlen fields).
    if all(
        not r.error and not r.metadata.get("owner", "") for r in resps
    ):
        import numpy as np

        out = np.zeros(len(resps), dtype=_string_resp_dtype())
        out["status"] = [int(r.status) for r in resps]
        out["limit"] = [r.limit for r in resps]
        out["remaining"] = [r.remaining for r in resps]
        out["reset_time"] = [r.reset_time for r in resps]
        return hdr + out.tobytes()
    parts = [hdr]
    for r in resps:
        err = r.error.encode()
        # metadata["owner"] rides the frame so forwarded responses keep
        # parity with the gRPC/gateway surface (reference
        # gubernator.go:151 sets it on every response)
        owner = r.metadata.get("owner", "").encode()
        parts.append(
            _RESP_FIX.pack(
                int(r.status), r.limit, r.remaining, r.reset_time
            )
        )
        parts.append(struct.pack("<H", len(err)))
        parts.append(err)
        parts.append(struct.pack("<H", len(owner)))
        parts.append(owner)
    return b"".join(parts)


class _ConnWindow:
    """Per-connection windowed-frame state: the write lock serializing
    out-of-order response writes, the credit semaphore (frames in
    flight; acquiring in the READ loop means an exhausted window stops
    reads and lets TCP backpressure the edge), and the live task set
    (cancelled when the connection dies so no task writes into a
    closed transport)."""

    def __init__(self, window: int):
        self.write_lock = asyncio.Lock()
        self.sem = asyncio.Semaphore(window)
        self.tasks: set = set()
        # smallest (bridge mono - edge stamp) seen on this connection:
        # the edge's monotonic epoch offset + its minimum transit.
        # Transit is observed RELATIVE to this, so a remote edge whose
        # CLOCK_MONOTONIC started at a different boot time calibrates
        # itself instead of poisoning the edge_to_bridge stage.
        # low_streak counts consecutive deltas implausibly far BELOW
        # the floor — a streak rebase recovers from a corrupt-small
        # first stamp that parked the floor sky-high.
        self.mono_base: Optional[float] = None
        self.low_streak: int = 0

    def track(self, task: "asyncio.Task") -> None:
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    def cancel_all(self) -> None:
        for t in list(self.tasks):
            t.cancel()


class FrameService:
    """Shared frame-service core (r12): one connection/frame engine
    serving the GEB wire protocol into the serving instance —
    hello, windowed + legacy framings, string fold, shed screen, stage
    clock, drain/GEBR semantics. Listeners are the subclasses' job:

      EdgeBridge   unix socket (co-located compiled edge) + optional
                   TCP (edges fronting other cluster nodes) — the
                   trusted internal cluster door (r5/r7)
      GebListener  the daemon's client-facing GEB door
                   (GUBER_GEB_PORT, r12) — the same protocol without
                   running the edge binary

    plus `serve_frame_bytes` for the body-per-request shape (the HTTP
    gateway's protobuf-free POST /v1/geb door). One core means the
    three doors cannot drift: a frame decodes, sheds, batches, and
    encodes identically wherever it arrives."""

    #: door label for trace spans/records (r16); the trusted edge
    #: bridge overrides
    _door = "geb"

    def __init__(
        self,
        instance,
        fast_enabled: bool = True,
        window: int = 0,
        string_fold: bool = True,
        peer_bridges: Optional[dict] = None,
        max_payload: int = MAX_FRAME_PAYLOAD,
        shm_enabled: bool = False,
        shm_ring_kib: int = 0,
        shm_poll_us: int = 0,
    ):
        self.instance = instance
        self.fast_enabled = fast_enabled
        self.string_fold = string_fold
        # shared-memory lane policy (r18, serve/shm.py): negotiated
        # per-connection via GEBM, advertised (HELLO_SHM) on unix
        # sockets only — the lane maps a same-host file
        self.shm_enabled = shm_enabled
        self.shm_ring_kib = shm_ring_kib
        self.shm_poll_us = shm_poll_us
        # per-door read-side payload cap: the client-facing doors bound
        # at MAX_FRAME_PAYLOAD; the trusted edge bridge passes
        # EDGE_MAX_FRAME_PAYLOAD (see the constants' rationale)
        self.max_payload = max_payload
        # explicit grpc_addr -> bridge_addr overrides (config
        # GUBER_EDGE_PEER_BRIDGES); falls back to the symmetric-fleet
        # port convention for unlisted peers
        self.peer_bridges = peer_bridges or {}
        for spec in self.peer_bridges.values():
            reject_ipv6_endpoint(spec, "GUBER_EDGE_PEER_BRIDGES entry")
        # 0 = default; GUBER_EDGE_WINDOW / GUBER_GEB_WINDOW are parsed
        # once, in config_from_env (server boots pass the conf value)
        if window <= 0:
            window = DEFAULT_WINDOW
        self.window = max(1, min(int(window), MAX_WINDOW))
        #: asyncio servers the subclass started; drain()/stop() close
        #: them generically
        self._servers: list = []
        # live connection writers: stop() must actively close them —
        # py3.12's Server.wait_closed() waits for HANDLERS to finish,
        # and a connected-but-idle edge parks its handler in
        # readexactly forever, wedging daemon shutdown otherwise
        self._conns: set = set()
        self._stopping = False
        # graceful drain (r8): set by drain() — read loops refuse NEW
        # frames with a GEBR drain code after answering the frames
        # already in flight; _active_frames counts frames accepted but
        # not yet answered so drain() can wait for exactly those
        self._draining = False
        self._active_frames = 0
        # (picker object, fingerprint) — see _ring_hash
        self._ring_hash_cache: Optional[tuple] = None

    def _bridge_advert_port(self) -> str:
        """Port peers' frame doors are advertised on in the hello
        (symmetric-fleet convention: every node listens on the same
        port). Empty = advertise peers door-less; subclasses with a
        TCP listener override."""
        return ""

    async def drain(self, timeout: float) -> None:
        """Graceful drain: stop accepting connections, refuse NEW
        frames (GEBR drain code — see the protocol header), and wait
        up to `timeout` for every frame already accepted to be
        answered. Connections stay open so those answers can be
        written; stop() closes them afterwards. No accepted frame is
        dropped unless the timeout expires."""
        self._draining = True
        for srv in self._servers:
            srv.close()
        deadline = time.monotonic() + max(0.0, timeout)
        while self._active_frames > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        if self._active_frames:
            log.warning(
                "edge drain timed out with %d frame(s) still in flight",
                self._active_frames,
            )

    async def stop(self) -> None:
        # flag first: a handler task accepted just before stop() may not
        # have RUN yet (so its writer isn't in _conns when the sweep
        # below looks) — it checks this flag on entry and exits instead
        # of parking in readexactly under wait_closed
        self._stopping = True
        for srv in self._servers:
            srv.close()
        # unblock parked handlers BEFORE wait_closed (see _conns note)
        for w in list(self._conns):
            w.close()
        for srv in self._servers:
            await srv.wait_closed()
        self._servers = []

    def _arrays_ok(self) -> bool:
        """The array decide path needs a backend that takes arrays —
        true for the device backends, false for e.g. the exact
        backend. Deliberately independent of the GUBER_EDGE_FAST kill
        switch: that switch governs the pre-hashed WIRE protocol, not
        this node's ability to decide arrays."""
        backend = getattr(self.instance, "backend", None)
        return (
            getattr(backend, "decide_submit_arrays", None) is not None
            and getattr(backend, "decide_submit", None) is not None
        )

    def _fast_ok(self) -> bool:
        """Pre-hashed frames need a backend that takes arrays. Ring
        soundness is no longer a single-node condition (r4): the edge
        routes each item to its ring owner itself and every fast frame
        carries the membership fingerprint it routed with, checked in
        the read loop — a frame routed under a different view is
        refused, so a grown cluster can no longer be silently
        over-admitted by a stale edge."""
        return self.fast_enabled and self._arrays_ok()

    def _ring_hash(self) -> int:
        # cached per picker OBJECT: windowed pipelining checks the
        # fingerprint on every fast frame (tens of thousands/s), so
        # rebuilding + sorting + crc32ing the address list per frame is
        # real event-loop work. The cache holds a STRONG reference to
        # the picker it hashed, so `is` identity is sound (no allocator
        # id reuse while referenced — the stale-fingerprint hazard that
        # kept this uncached pre-r7); set_peers installs a NEW picker
        # per update, which misses the cache and recomputes.
        picker = getattr(self.instance, "picker", None)
        if picker is None:
            return ring_fingerprint([])
        cached = self._ring_hash_cache
        if cached is not None and cached[0] is picker:
            return cached[1]
        try:
            hosts = [p.host for p in picker.peers()]
        except Exception:
            hosts = []
        h = ring_fingerprint(hosts)
        self._ring_hash_cache = (picker, h)
        return h

    def _hello(self, shm: bool = False) -> bytes:
        """Capability + ring hello. Peer bridge endpoints follow the
        symmetric-fleet convention: every node's bridge listens on the
        same TCP port (the port of this node's GUBER_EDGE_TCP), on the
        same host as its gRPC address. When GUBER_EDGE_TCP is unset,
        peers get empty bridge endpoints and the edge routes their keys
        through the string path (instance-side gRPC forwarding) — the
        pre-r5 behavior, now per-item instead of all-or-nothing. An
        IPv6 peer gRPC host cannot produce a valid bridge endpoint;
        it is advertised bridge-less rather than misparsably."""
        picker = getattr(self.instance, "picker", None)
        peers = []
        if picker is not None:
            try:
                peers = sorted(picker.peers(), key=lambda p: p.host)
            except Exception:
                peers = []
        bridge_port = self._bridge_advert_port()
        # HELLO_TRACE is a protocol capability (this core decodes GEBT
        # frames), not a sampling policy — advertised unconditionally
        flags = HELLO_WINDOWED | HELLO_TRACE | (self.window << 16)
        if shm:
            # per-CONNECTION capability (r18): only a unix-socket
            # client of an shm-enabled service sees this bit
            flags |= HELLO_SHM
        # HELLO_CHAIN is never set: the port serves no quota chains, so
        # a chaining client's capability check fails fast instead of
        # shipping frames that would only be refused per item (the
        # reference's rationale for its GUBER_CHAINS=0 switch)
        if self._fast_ok():
            flags |= HELLO_FAST
            # hash-implementation bit (r12): pre-hashing clients check
            # it against their own hasher before choosing fast framing;
            # on a blake2b-8 store the edge bridge withholds HELLO_FAST
            # itself (EdgeBridge._fast_ok, module docstring)
            if slot_hash_is_xxh64():
                flags |= HELLO_XXH64
        parts = [
            struct.pack(
                "<IIII",
                MAGIC_HELLO,
                flags,
                self._ring_hash(),
                len(peers),
            )
        ]
        for p in peers:
            grpc_addr = p.host.encode()
            if p.is_owner:
                bridge = b""
            elif p.host in self.peer_bridges:
                bridge = self.peer_bridges[p.host].encode()
            elif bridge_port and p.host.count(":") == 1 and \
                    "[" not in p.host:
                bridge = (
                    p.host.rpartition(":")[0] + ":" + bridge_port
                ).encode()
            else:
                bridge = b""
            parts.append(struct.pack("<BH", 1 if p.is_owner else 0,
                                     len(grpc_addr)))
            parts.append(grpc_addr)
            parts.append(struct.pack("<H", len(bridge)))
            parts.append(bridge)
        return b"".join(parts)

    def hello_bytes(self) -> bytes:
        """The encoded GEBI hello — public accessor for the HTTP
        binary door (GET /v1/geb serves it so a fast client can
        negotiate without a socket)."""
        return self._hello()

    async def _decide_arrays_chunked(self, fields: dict, n: int):
        """Run one frame's array fields through the batcher, splitting
        past MAX_BATCH_SIZE: one group never outgrows the batcher's
        ladder, whose top rung is that size, so every group fits one
        device batch and co-batches with others. Chunks gather so they all enqueue at once and co-batch / ride
        the fetch pipeline instead of paying one device round trip
        each; only chunk 0 carries the frame's stage span (n chunks
        must not record n device spans for one frame). Returns the
        (status, limit, remaining, reset_time) arrays for all n rows.
        Shared by the pre-hashed fast path and the string fold."""
        if n <= MAX_BATCH_SIZE:
            return await self.instance.batcher.decide_arrays(fields)
        import numpy as np

        parts = await asyncio.gather(
            *[
                self.instance.batcher.decide_arrays(
                    {
                        k: v[i : i + MAX_BATCH_SIZE]
                        for k, v in fields.items()
                    },
                    frame=(i == 0),
                )
                for i in range(0, n, MAX_BATCH_SIZE)
            ]
        )
        return tuple(
            np.concatenate([p[j] for p in parts]) for j in range(4)
        )

    async def _decide_arrays_shed(self, fields: dict, n: int):
        """Over-limit shed screen in front of the batcher (r10,
        serve/shedcache.py): items whose frozen token-bucket refusal
        is cached host-side are answered HERE and never enqueue; only
        the residue rides the device, and its responses stitch back in
        frame order (and repopulate the cache). Screen + stitch time
        is the frame's `shed` stage — a fully-shed frame has no
        batch_queue/device span at all, and this stage is what tiles
        that part of its e2e, so the r7 frame-coverage contract keeps
        no hole. Shared by the pre-hashed fast path and the string
        fold."""
        shed = getattr(self.instance, "shed", None)
        if shed is None:
            return await self._decide_arrays_chunked(fields, n)
        t0 = time.monotonic()
        shed.refresh_generation()
        screened = shed.screen_fields(fields)
        if screened is None:
            STAGES.add("shed", time.monotonic() - t0)
            res = await self._decide_arrays_chunked(fields, n)
            # population is shed work too: without the stage add, a
            # cold-cache frame's observe walk would sit between the
            # device and encode spans as a coverage hole
            t1 = time.monotonic()
            shed.observe_fields(fields, res)
            STAGES.add("shed", time.monotonic() - t1)
            return res
        mask, (status, limit, remaining, reset) = screened
        keep = ~mask
        n_res = int(keep.sum())
        if n_res == 0:
            STAGES.add("shed", time.monotonic() - t0)
            return status, limit, remaining, reset
        residue = {k: v[keep] for k, v in fields.items()}
        STAGES.add("shed", time.monotonic() - t0)
        rs, rl, rr, rt = await self._decide_arrays_chunked(
            residue, n_res
        )
        t1 = time.monotonic()
        shed.observe_fields(residue, (rs, rl, rr, rt))
        status[keep] = rs
        limit[keep] = rl
        remaining[keep] = rr
        reset[keep] = rt
        STAGES.add("shed", time.monotonic() - t1)
        return status, limit, remaining, reset

    async def _decide_fast(self, payload: bytes, n: int):
        """Decode one pre-hashed payload and run it through the batcher.
        Returns the packed n x 25-byte response records."""
        import numpy as np

        t_dec = time.monotonic()
        req_dt, resp_dt = _fast_dtypes()
        if len(payload) != n * req_dt.itemsize:
            raise ValueError("fast payload length mismatch")
        if not self._fast_ok():
            # wrong backend for pre-hashed frames: refuse loudly; the
            # edge reconnects and re-handshakes onto the string path
            raise ValueError(
                "fast frame but fast path unavailable (non-array backend)"
            )
        metrics.EDGE_FAST_ITEMS.inc(n)
        rec = np.frombuffer(payload, dtype=req_dt)
        fields = dict(
            key_hash=np.ascontiguousarray(rec["key_hash"]),
            hits=np.ascontiguousarray(rec["hits"]),
            limit=np.ascontiguousarray(rec["limit"]),
            duration=np.ascontiguousarray(rec["duration"]),
            algo=np.ascontiguousarray(rec["algo"]).astype(np.int32),
        )
        # distinct-key observability: feed the HLL with the hashes so
        # /v1/debug/stats stays meaningful under fast-path traffic
        # (hot-key NAMES are unavailable here by design)
        self.instance.traffic.observe_hashes(fields["key_hash"])
        STAGES.add("bridge_decode", time.monotonic() - t_dec)
        status, limit, remaining, reset = (
            await self._decide_arrays_shed(fields, n)
        )
        t_enc = time.monotonic()
        out = np.empty(n, dtype=resp_dt)
        out["status"] = np.asarray(status, np.int64).astype(np.uint8)
        out["limit"] = limit
        out["remaining"] = remaining
        out["reset_time"] = reset
        raw = out.tobytes()
        STAGES.add("encode", time.monotonic() - t_enc)
        return raw

    async def _decide_string(
        self, payload: bytes, n: int, decoder=decode_request_frame
    ):
        """Decode one string-item payload and serve it through the full
        instance (validation, routing, forwarding). Returns the
        response list, one per item, in order. `decoder` swaps in the
        GEBC chain-item decoder for chain-extended frames (r15)."""
        t_dec = time.monotonic()
        decoded = decoder(payload, n)
        STAGES.add("bridge_decode", time.monotonic() - t_dec)
        good = [r for r in decoded if r is not None]
        # the edge caps frames at its batch limit, but two large
        # co-batched requests can still exceed the instance's
        # MAX_BATCH_SIZE — split instead of erroring the frame
        good_resps = []
        for i in range(0, len(good), MAX_BATCH_SIZE):
            good_resps.extend(
                await self.instance.get_rate_limits(
                    good[i : i + MAX_BATCH_SIZE],
                    # one frame = one per-frame stage span: only the
                    # first chunk represents it in the stage clock
                    stage_frame=(i == 0),
                )
            )
        it = iter(good_resps)
        return [
            next(it)
            if r is not None
            else RateLimitResp(
                error="name or unique_key is not valid UTF-8"
            )
            for r in decoded
        ]

    def _fold_string_frame(self, payload: bytes, n: int):
        """Lean parse + eligibility screen for the string->array fold
        (r7 slow-path owner batching, bridge side). When EVERY item in
        a string frame is plain (BATCHING/NO_BATCHING, non-empty UTF-8
        name/key) and owned by this node under the current ring, the
        frame needs no request/response objects and no instance
        routing: it rides the same array path as pre-hashed frames.
        Per-owner slow shards from the edge are all-plain all-owned by
        construction, so the GUBER_EDGE_FAST=0 kill switch and mixed
        fleets get fast-path treatment minus only the client-side
        hashing. Returns (full_keys, fields) or None; None falls back
        to the object path, which keeps full semantics for GLOBAL
        items, per-item validation errors, and items a stale edge
        routed to the wrong owner (forwarded by the instance there).
        """
        import numpy as np

        picker = getattr(self.instance, "picker", None)
        mask_fn = getattr(picker, "self_owned_mask", None)
        if mask_fn is None or not getattr(picker, "size", lambda: 0)():
            return None
        # the wire count is untrusted: bound it by the payload's
        # minimum bytes/item (2+2 length prefixes + 26 fixed) before
        # sizing arrays from it, like _decide_fast's exact-length check
        if n > len(payload) // 30:
            return None
        full: List[str] = []
        hits = np.empty(n, np.int64)
        limit = np.empty(n, np.int64)
        duration = np.empty(n, np.int64)
        algo = np.empty(n, np.int64)
        off = 0
        # ownership is screened in chunks DURING the parse: a mixed-
        # ownership frame (pre-r7 edge funnelling a cluster's items
        # through one node) is near-certain to fail within its first
        # chunk, so it pays ~256 items of lean parse before falling
        # back to the object path instead of a full parse + re-parse
        checked = 0
        try:
            for i in range(n):
                if i - checked >= 256:
                    if not mask_fn(full[checked:]).all():
                        return None
                    checked = i
                (nlen,) = struct.unpack_from("<H", payload, off)
                off += 2
                raw_name = payload[off : off + nlen]
                off += nlen
                (klen,) = struct.unpack_from("<H", payload, off)
                off += 2
                raw_key = payload[off : off + klen]
                off += klen
                h, li, d, a, b = _ITEM_FIX.unpack_from(payload, off)
                off += _ITEM_FIX.size
                if (
                    len(raw_name) != nlen
                    or len(raw_key) != klen
                    or not raw_name
                    or not raw_key
                    or b == 2
                ):
                    return None  # truncated/invalid/GLOBAL: object path
                full.append(raw_name.decode() + "_" + raw_key.decode())
                hits[i] = h
                limit[i] = li
                duration[i] = d
                algo[i] = a
        except (struct.error, UnicodeDecodeError):
            return None  # malformed frame: the object path answers it
        if off != len(payload):
            return None
        if full[checked:] and not mask_fn(full[checked:]).all():
            return None
        fields = dict(
            key_hash=slot_hash_batch(full),
            hits=hits,
            limit=limit,
            duration=duration,
            # unknown algorithm bytes clamp to the default, matching
            # decode_request_frame and the JSON gateway
            algo=np.where(algo <= 3, algo, 0).astype(np.int32),
        )
        return full, fields

    async def _decide_string_folded(self, full, fields, n: int) -> bytes:
        """Array-decide one folded string frame and encode the GEB3/
        GEB4 response body (25-byte decisions + empty error/owner) in
        one numpy pass. Hot-key observability keeps full parity with
        the object path: names AND hashes feed the sketches."""
        import numpy as np

        # (the reference also feeds folded windows to its replication,
        # rescale and checkpoint managers here; the port's Instance
        # refuses a config that turns one on)
        self.instance.traffic.observe(full, fields["key_hash"])
        status, limit, remaining, reset = (
            await self._decide_arrays_shed(fields, n)
        )
        t_enc = time.monotonic()
        out = np.zeros(n, dtype=_string_resp_dtype())
        out["status"] = np.asarray(status, np.int64).astype(np.uint8)
        out["limit"] = limit
        out["remaining"] = remaining
        out["reset_time"] = reset
        raw = out.tobytes()
        STAGES.add("encode", time.monotonic() - t_enc)
        return raw

    async def _decide_string_frame(
        self, payload: bytes, n: int, magic=MAGIC_RESP, frame_id=None
    ) -> bytes:
        """Serve one string frame to a complete encoded response frame.
        Tries the array fold first; anything it declines rides the
        object path through the full instance."""
        t_dec = time.monotonic()
        fold = None
        if self.string_fold and n and self._arrays_ok():
            fold = self._fold_string_frame(payload, n)
        if fold is not None:
            metrics.EDGE_FOLDED_ITEMS.inc(n)
            STAGES.add("bridge_decode", time.monotonic() - t_dec)
            hdr = _HDR.pack(magic, n)
            if frame_id is not None:
                hdr += struct.pack("<I", frame_id)
            return hdr + await self._decide_string_folded(*fold, n)
        resps = await self._decide_string(payload, n)
        t_enc = time.monotonic()
        frame = encode_response_frame(resps, magic=magic, frame_id=frame_id)
        STAGES.add("encode", time.monotonic() - t_enc)
        return frame

    @staticmethod
    def _observe_transit(
        wstate: "_ConnWindow", t_frame0: float, t_sent_us: int
    ) -> float:
        """edge->bridge transit from the frame's monotonic stamp,
        calibrated per connection: CLOCK_MONOTONIC epochs differ
        between hosts (boot-relative), so the raw delta is only
        meaningful up to a constant offset. The smallest delta seen on
        the connection (epoch offset + minimum transit) is taken as
        zero and every frame's transit observed relative to it — on a
        co-located edge that floor is the ~µs unix-socket hop, and on
        a remote edge the boot-time skew self-cancels instead of
        recording as 20s of phantom transit. What the stage then
        measures is time spent ABOVE the connection's floor: credit-
        window queueing and socket backlog, the actionable part.
        Returns the observed transit (0.0 when unstamped or
        implausible) so the frame's e2e clock can start at the SEND
        stamp — keeping the per-frame stages and their coverage
        denominator on the same span."""
        if t_sent_us <= 0:
            return 0.0
        dt = t_frame0 - t_sent_us / 1e6
        if wstate.mono_base is None:
            wstate.mono_base = dt
        elif dt < wstate.mono_base:
            # recorded transits are bounded at 60s, so a genuine floor
            # can only improve by less than that; a single
            # future-dated/corrupt stamp must not poison the floor for
            # the connection's lifetime — treat it as unstamped. But a
            # STREAK of far-below deltas means the floor itself is
            # bogus (the first stamp was corrupt-small, so mono_base is
            # sky-high): rebase down rather than zeroing the stage for
            # every frame that follows.
            if wstate.mono_base - dt >= 60.0:
                wstate.low_streak += 1
                if wstate.low_streak < 3:
                    return 0.0
                wstate.mono_base = dt
            else:
                wstate.mono_base = dt
            wstate.low_streak = 0
        else:
            wstate.low_streak = 0
        transit = dt - wstate.mono_base
        if transit < 60.0:  # desynced-stream garbage guard
            STAGES.add("edge_to_bridge", transit)
            return transit
        # implausible gap above the floor: the FLOOR is what's bogus
        # (e.g. the connection's first stamp was garbage) — re-base on
        # this frame so one bad first sample can't zero the stage for
        # every frame that follows
        wstate.mono_base = dt
        return 0.0

    async def _serve_windowed(
        self, magic, payload, n, frame_id, t_start, writer, wstate,
        rctx=None,
    ):
        """One windowed frame, served concurrently with its siblings.
        Runs as its own task; the response is written under the
        connection's write lock whenever it completes (out of order is
        fine — the edge matches on frame_id). `t_start` is the frame's
        e2e clock start: the edge's send stamp when the frame carried
        one, else the bridge's read time. `rctx` is a GEBT frame's
        carried trace context; frames without one are head/tail
        sampled by this node's tracer (r16)."""
        try:
            if FAULTS.enabled:
                # edge_frame injection point: delay stretches this
                # frame's service; error poisons the connection (the
                # generic handler below), like a real decode/serve crash
                await FAULTS.inject("edge_frame")
            tracer = getattr(self.instance, "tracer", None)
            trace = (
                tracer.join(self._door, rctx)
                if tracer is not None
                else None
            )
            if trace is not None:
                # the trace's e2e clock is the frame's (send stamp
                # when carried), so trace duration == add_frame's e2e
                trace.t0 = t_start
                trace.annotate(items=n, frame_id=frame_id)
            with tracing.scope(tracer, trace):
                if magic == MAGIC_WFAST_REQ:
                    raw = await self._decide_fast(payload, n)
                    frame = (
                        _HDR.pack(MAGIC_WFAST_RESP, n)
                        + struct.pack("<I", frame_id)
                        + raw
                    )
                elif magic == MAGIC_WCHAIN:
                    # chain-extended string frame (r15): always the
                    # object path — chains need the instance's
                    # routing/validation and are never foldable
                    # (coupled multi-key decides)
                    resps = await self._decide_string(
                        payload, n, decoder=decode_chain_request_frame
                    )
                    t_enc = time.monotonic()
                    frame = encode_response_frame(
                        resps, magic=MAGIC_WRESP, frame_id=frame_id
                    )
                    STAGES.add("encode", time.monotonic() - t_enc)
                else:
                    # GEB2 and GEBT (the trace extension changes the
                    # header, not the item payload or the response)
                    frame = await self._decide_string_frame(
                        payload, n, magic=MAGIC_WRESP, frame_id=frame_id
                    )
                async with wstate.write_lock:
                    writer.write(frame)
                    await writer.drain()
            STAGES.add_frame(time.monotonic() - t_start)
        except asyncio.CancelledError:
            raise
        except (ConnectionResetError, BrokenPipeError):
            pass  # edge went away mid-response; reader loop cleans up
        except Exception:
            # a malformed frame or dead batcher poisons the whole
            # connection (the stream may be desynced): close it; the
            # edge fails in-flight frames and reconnects
            log.exception("windowed edge frame failed")
            writer.close()
        finally:
            wstate.sem.release()

    async def _refuse_draining(self, writer, wstate, frame_id: int):
        """Drain-refuse one just-read frame: first let every frame
        already in flight on this connection finish (their responses
        ride the still-open writer — no accepted frame is lost), then
        send the GEBR drain code for the frame that will NOT be served
        and close the connection by returning."""
        if wstate.tasks:
            await asyncio.gather(
                *list(wstate.tasks), return_exceptions=True
            )
        async with wstate.write_lock:
            writer.write(_HDR.pack(MAGIC_STALE, frame_id))
            await writer.drain()

    def _frame_begun(self) -> None:
        self._active_frames += 1

    def _frame_done(self, *_args) -> None:
        self._active_frames -= 1

    def _conn_shm_ok(self, writer) -> bool:
        """Shared-memory lanes are negotiable on this connection only
        when the service allows them AND the transport proves
        same-hostness (AF_UNIX)."""
        if not self.shm_enabled:
            return False
        import socket as _socket

        sock = writer.get_extra_info("socket")
        return (
            sock is not None
            and getattr(sock, "family", None) == _socket.AF_UNIX
        )

    async def _serve_conn(self, reader, writer):
        if self._stopping or self._draining:
            writer.close()
            return
        self._conns.add(writer)
        wstate = _ConnWindow(self.window)
        shm_ok = self._conn_shm_ok(writer)
        shm_sess = None
        try:
            # ring-carrying hello: capability flags + live membership
            # (rebuilt per connection; the edge refreshes by reconnecting)
            writer.write(self._hello(shm=shm_ok))
            await writer.drain()
            while True:
                hdr = await reader.readexactly(_HDR.size)
                t_frame0 = time.monotonic()
                magic, n = _HDR.unpack(hdr)
                if magic == MAGIC_SHM_REQ:
                    # map-the-ring negotiation (r18): n is the client's
                    # ring-size hint in KiB (0 = server default). One
                    # lane per connection; anything off-policy answers
                    # a refusal (path_len 0) and the socket continues.
                    from gubernator_tpu_torch.serve import shm as shm_mod

                    reply = None
                    if (
                        shm_ok
                        and shm_sess is None
                        and not self._draining
                    ):
                        try:
                            shm_sess, reply = (
                                shm_mod.open_server_session(
                                    self, n, writer
                                )
                            )
                        except Exception:
                            log.exception("shm lane negotiation failed")
                            shm_sess, reply = None, None
                    if reply is None:
                        reply = shm_mod.shm_refusal()
                    async with wstate.write_lock:
                        writer.write(reply)
                        await writer.drain()
                    continue
                if magic in (
                    MAGIC_WFAST_REQ, MAGIC_WREQ, MAGIC_WCHAIN,
                    MAGIC_WTRACE,
                ):
                    rctx = None
                    if magic == MAGIC_WFAST_REQ:
                        frame_id, frame_ring, t_sent = _WFAST_HDR.unpack(
                            await reader.readexactly(_WFAST_HDR.size)
                        )
                    else:
                        frame_id, t_sent = _WREQ_HDR.unpack(
                            await reader.readexactly(_WREQ_HDR.size)
                        )
                        frame_ring = None
                        if magic == MAGIC_WTRACE:
                            # trace-extended header (r16): the carried
                            # context joins the sender's distributed
                            # trace
                            raw_tid, span_id, tflags = _WTRACE_EXT.unpack(
                                await reader.readexactly(_WTRACE_EXT.size)
                            )
                            rctx = _trace_ctx_from_ext(
                                raw_tid, span_id, tflags
                            )
                    (plen,) = struct.unpack(
                        "<I", await reader.readexactly(4)
                    )
                    payload = await reader.readexactly(
                        bound_payload_len(plen, self.max_payload)
                    )
                    if (
                        frame_ring is not None
                        and frame_ring != self._ring_hash()
                    ):
                        # routed under a different membership view —
                        # refuse the frame AND the connection; frames
                        # still in flight were routed with the same
                        # stale view and fail edge-side when the close
                        # lands. The write lock keeps the GEBR from
                        # interleaving a concurrent response write.
                        metrics.EDGE_STALE_RINGS.inc()
                        log.warning(
                            "refusing fast frame routed with stale ring "
                            "(%#x != %#x)", frame_ring, self._ring_hash()
                        )
                        async with wstate.write_lock:
                            writer.write(_HDR.pack(MAGIC_STALE, frame_id))
                            await writer.drain()
                        return
                    if self._draining:
                        # answered in-flight frames first, then refuse
                        # this one with the drain code
                        await self._refuse_draining(
                            writer, wstate, DRAIN_FRAME_ID
                        )
                        return
                    transit = self._observe_transit(
                        wstate, t_frame0, t_sent
                    )
                    # credit gate: acquired BEFORE reading the next
                    # frame, so an edge overrunning the advertised
                    # window parks here and TCP backpressure does the
                    # policing — no frame is ever dropped
                    await wstate.sem.acquire()
                    self._frame_begun()
                    task = asyncio.ensure_future(
                        self._serve_windowed(
                            magic, payload, n, frame_id,
                            t_frame0 - transit, writer, wstate,
                            rctx=rctx,
                        )
                    )
                    task.add_done_callback(self._frame_done)
                    wstate.track(task)
                    continue
                if magic == MAGIC_FAST_REQ:
                    frame_ring, plen = struct.unpack(
                        "<II", await reader.readexactly(8)
                    )
                    payload = await reader.readexactly(
                        bound_payload_len(plen, self.max_payload)
                    )
                    if frame_ring != self._ring_hash():
                        metrics.EDGE_STALE_RINGS.inc()
                        log.warning(
                            "refusing fast frame routed with stale ring "
                            "(%#x != %#x)", frame_ring, self._ring_hash()
                        )
                        writer.write(_HDR.pack(MAGIC_STALE, 0))
                        await writer.drain()
                        return
                    if self._draining:
                        # GEB6's reader understands GEBR; carry the
                        # drain code like the windowed framings (the
                        # pre-r8 edge ignores the id field here)
                        await self._refuse_draining(
                            writer, wstate, DRAIN_FRAME_ID
                        )
                        return
                    self._frame_begun()
                    try:
                        tracer = getattr(self.instance, "tracer", None)
                        trace = (
                            tracer.begin(self._door)
                            if tracer is not None
                            else None
                        )
                        with tracing.scope(tracer, trace):
                            raw = await self._decide_fast(payload, n)
                            writer.write(
                                _HDR.pack(MAGIC_FAST_RESP, n) + raw
                            )
                            await writer.drain()
                    finally:
                        self._frame_done()
                    STAGES.add_frame(time.monotonic() - t_frame0)
                    continue
                if magic != MAGIC_REQ:
                    raise ValueError(f"bad magic {magic:#x}")
                (plen,) = struct.unpack(
                    "<I", await reader.readexactly(4)
                )
                payload = await reader.readexactly(
                    bound_payload_len(plen, self.max_payload)
                )
                if self._draining:
                    # the GEB1 string reader predates GEBR entirely (a
                    # stale magic is a hard protocol failure there), so
                    # drain-refuse with a well-formed GEB3 response
                    # carrying per-item errors — degraded, in-protocol.
                    # Wire count bounded by the payload's minimum
                    # bytes/item first: this branch allocates n
                    # responses and the GEB door is client-facing.
                    if n > len(payload) // 30:
                        raise ValueError(
                            "item count exceeds payload bound"
                        )
                    writer.write(
                        encode_response_frame(
                            [
                                RateLimitResp(error="node draining")
                                for _ in range(n)
                            ]
                        )
                    )
                    await writer.drain()
                    return
                self._frame_begun()
                try:
                    tracer = getattr(self.instance, "tracer", None)
                    trace = (
                        tracer.begin(self._door)
                        if tracer is not None
                        else None
                    )
                    with tracing.scope(tracer, trace):
                        writer.write(
                            await self._decide_string_frame(payload, n)
                        )
                        await writer.drain()
                finally:
                    self._frame_done()
                STAGES.add_frame(time.monotonic() - t_frame0)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            log.exception("edge bridge connection error")
        finally:
            # in-flight windowed tasks must not write into the closing
            # transport or outlive the connection
            if shm_sess is not None:
                shm_sess.close()
            wstate.cancel_all()
            self._conns.discard(writer)
            writer.close()

    async def serve_frame_bytes(
        self, data: bytes, remote_ctx=None
    ) -> bytes:
        """Serve ONE complete request frame carried as a byte string
        and return the complete encoded response frame — the body-per-
        request shape of the HTTP gateway's protobuf-free POST /v1/geb
        door (serve/server.py). All request framings are accepted
        (GEB1/GEB6 legacy, GEB2/GEB7 windowed, GEBC chain-extended,
        GEBT trace-extended — the windowed frame ids are echoed but
        carry no pipelining here: HTTP gives each frame its own
        request/response exchange). Malformed input raises
        ValueError (the gateway answers 400); a stale-ring fast frame
        or a draining node returns a GEBR frame, exactly as on the
        socket doors. Runs the same shed screen, stage clock, trace
        sampling (`remote_ctx`: a traceparent header's parsed context;
        a GEBT frame's in-band context wins), and drain accounting as
        a socket frame."""
        if len(data) < _HDR.size:
            raise ValueError("short frame")
        magic, n = _HDR.unpack_from(data, 0)
        off = _HDR.size
        t0 = time.monotonic()
        frame_id: Optional[int] = None
        frame_ring: Optional[int] = None
        if magic == MAGIC_WFAST_REQ:
            if len(data) < off + _WFAST_HDR.size + 4:
                raise ValueError("short GEB7 header")
            frame_id, frame_ring, _t_sent = _WFAST_HDR.unpack_from(
                data, off
            )
            off += _WFAST_HDR.size
        elif magic in (MAGIC_WREQ, MAGIC_WCHAIN, MAGIC_WTRACE):
            if len(data) < off + _WREQ_HDR.size + 4:
                raise ValueError("short GEB2/GEBC/GEBT header")
            frame_id, _t_sent = _WREQ_HDR.unpack_from(data, off)
            off += _WREQ_HDR.size
            if magic == MAGIC_WTRACE:
                if len(data) < off + _WTRACE_EXT.size + 4:
                    raise ValueError("short GEBT trace extension")
                raw_tid, span_id, tflags = _WTRACE_EXT.unpack_from(
                    data, off
                )
                off += _WTRACE_EXT.size
                remote_ctx = (
                    _trace_ctx_from_ext(raw_tid, span_id, tflags)
                    or remote_ctx
                )
        elif magic == MAGIC_FAST_REQ:
            if len(data) < off + 8:
                raise ValueError("short GEB6 header")
            (frame_ring,) = struct.unpack_from("<I", data, off)
            off += 4
        elif magic != MAGIC_REQ:
            raise ValueError(f"bad magic {magic:#x}")
        if len(data) < off + 4:
            raise ValueError("short frame")
        (plen,) = struct.unpack_from("<I", data, off)
        off += 4
        bound_payload_len(plen, self.max_payload)
        if off + plen != len(data):
            raise ValueError("frame length mismatch")
        payload = bytes(data[off:])
        if frame_ring is not None and frame_ring != self._ring_hash():
            metrics.EDGE_STALE_RINGS.inc()
            return _HDR.pack(
                MAGIC_STALE, frame_id if frame_id is not None else 0
            )
        if self._draining:
            if magic == MAGIC_REQ:
                # GEB1 predates GEBR: refuse in-protocol (socket
                # parity). The wire count is untrusted and this branch
                # allocates n responses, so bound it by the payload's
                # minimum bytes/item (30) BEFORE building anything —
                # a lying header must not be an OOM vector mid-drain.
                if n > len(payload) // 30:
                    raise ValueError("item count exceeds payload bound")
                return encode_response_frame(
                    [
                        RateLimitResp(error="node draining")
                        for _ in range(n)
                    ]
                )
            return _HDR.pack(MAGIC_STALE, DRAIN_FRAME_ID)
        self._frame_begun()
        try:
            if FAULTS.enabled:
                await FAULTS.inject("edge_frame")
            tracer = getattr(self.instance, "tracer", None)
            trace = (
                tracer.join(self._door, remote_ctx)
                if tracer is not None
                else None
            )
            if trace is not None:
                trace.t0 = t0
                trace.annotate(items=n)
            with tracing.scope(tracer, trace):
                if magic in (MAGIC_WFAST_REQ, MAGIC_FAST_REQ):
                    raw = await self._decide_fast(payload, n)
                    if magic == MAGIC_WFAST_REQ:
                        frame = (
                            _HDR.pack(MAGIC_WFAST_RESP, n)
                            + struct.pack("<I", frame_id)
                            + raw
                        )
                    else:
                        frame = _HDR.pack(MAGIC_FAST_RESP, n) + raw
                elif magic == MAGIC_WCHAIN:
                    # chain-extended items (r15): object path only
                    resps = await self._decide_string(
                        payload, n, decoder=decode_chain_request_frame
                    )
                    t_enc = time.monotonic()
                    frame = encode_response_frame(
                        resps, magic=MAGIC_WRESP, frame_id=frame_id
                    )
                    STAGES.add("encode", time.monotonic() - t_enc)
                elif magic in (MAGIC_WREQ, MAGIC_WTRACE):
                    frame = await self._decide_string_frame(
                        payload, n, magic=MAGIC_WRESP, frame_id=frame_id
                    )
                else:
                    frame = await self._decide_string_frame(payload, n)
        finally:
            self._frame_done()
        STAGES.add_frame(time.monotonic() - t0)
        return frame


class EdgeBridge(FrameService):
    """Unix-socket (+ optional TCP) server feeding edge batches into the
    serving instance. The unix socket serves a co-located edge; the TCP
    listener serves edges fronting OTHER nodes of the cluster, which
    ship pre-hashed frames for keys this node owns (cluster fast path,
    r5). Windowed framing (r7) lets one connection carry `window`
    concurrent frames. Internal cluster door — see the trust boundary
    note in the module docstring."""

    _door = "edge"

    def __init__(
        self,
        instance,
        path: str,
        tcp_address: str = "",
        peer_bridges: Optional[dict] = None,
        fast_enabled: bool = True,
        window: int = 0,
        string_fold: bool = True,
        max_payload: int = EDGE_MAX_FRAME_PAYLOAD,
        shm_enabled: bool = False,
        shm_ring_kib: int = 0,
        shm_poll_us: int = 0,
    ):
        super().__init__(
            instance,
            fast_enabled=fast_enabled,
            window=window,
            string_fold=string_fold,
            peer_bridges=peer_bridges,
            max_payload=max_payload,
            shm_enabled=shm_enabled,
            shm_ring_kib=shm_ring_kib,
            shm_poll_us=shm_poll_us,
        )
        self.path = path
        if tcp_address:
            reject_ipv6_endpoint(tcp_address, "GUBER_EDGE_TCP")
        self.tcp_address = tcp_address

    def _bridge_advert_port(self) -> str:
        if self.tcp_address:
            return self.tcp_address.rpartition(":")[2]
        return ""

    def _fast_ok(self) -> bool:
        """Pre-hashed frames on this door come from the compiled edge,
        which hashes XXH64 and never reads HELLO_XXH64: offer (and
        accept) them only when the store hashes XXH64 too, or a key
        would count in two rows (module docstring)."""
        return slot_hash_is_xxh64() and super()._fast_ok()

    async def start(self) -> None:
        self._stopping = False
        self._draining = False
        if self.path:
            srv = await asyncio.start_unix_server(
                self._serve_conn, path=self.path
            )
            self._servers.append(srv)
            log.info("edge bridge listening on %s", self.path)
        if self.tcp_address:
            host, _, port = self.tcp_address.rpartition(":")
            srv = await asyncio.start_server(
                self._serve_conn, host=host or "0.0.0.0", port=int(port)
            )
            self._servers.append(srv)
            log.info("edge bridge listening on tcp %s", self.tcp_address)


class GebListener(FrameService):
    """The daemon's client-facing GEB door (GUBER_GEB_PORT, r12): the
    windowed binary frame protocol as a first-class CLIENT protocol,
    without running the edge binary. Speaks exactly the bridge framing
    (one shared FrameService core), so gubernator_tpu_torch.client_geb gets
    hello negotiation, credit-windowed pipelining, out-of-order
    completion, the shed screen, and GEBR drain/stale semantics
    against any daemon.

    Peers in the hello advertise THEIR GEB doors under the
    symmetric-fleet port convention (every node listens on the same
    GUBER_GEB_PORT), so a topology-aware client can route per owner
    the way the compiled edge does.

    Trust note: pre-hashed fast frames (GEB6/GEB7) bypass instance
    routing — like the bridge, this door trusts a matching ring
    fingerprint and decides the items locally. The packaged client
    only uses fast framing against single-node rings (client_geb.py
    auto mode); string frames (GEB2) keep full routing/forwarding
    semantics on any topology and any client."""

    def __init__(
        self,
        instance,
        address: str,
        fast_enabled: bool = True,
        window: int = 0,
        string_fold: bool = True,
        peer_bridges: Optional[dict] = None,
    ):
        # peer_bridges (r18, GUBER_GEB_PEER_DOORS): explicit
        # grpc_addr -> geb_door overrides for fleets where the
        # symmetric-port convention doesn't hold (several nodes on one
        # host) — the ring-routing client needs every peer's door
        super().__init__(
            instance,
            fast_enabled=fast_enabled,
            window=window,
            string_fold=string_fold,
            peer_bridges=peer_bridges,
        )
        reject_ipv6_endpoint(address, "GUBER_GEB_PORT listener")
        self.address = address

    def _bridge_advert_port(self) -> str:
        return self.address.rpartition(":")[2]

    async def start(self) -> None:
        self._stopping = False
        self._draining = False
        host, _, port = self.address.rpartition(":")
        srv = await asyncio.start_server(
            self._serve_conn, host=host or "0.0.0.0", port=int(port)
        )
        self._servers.append(srv)
        log.info("GEB client protocol listening on tcp %s", self.address)
