"""Shared-memory GEB lane (r18): a mmap'd ring-buffer transport for
the windowed frame protocol between a same-host client and a bridge.

The port's copy of gubernator_tpu/serve/shm.py with its imports
rewritten; the file references below are the reference package's. It
imports no torch: the client side (client_geb.py) maps the same lane.

The r12 front-door ladder left the co-located hop paying a full kernel
socket round trip per frame window. This module removes it: after the
normal GEBI hello on a unix control socket, a client that saw the
HELLO_SHM capability bit sends one GEBM request and the bridge maps a
fresh two-ring file (tempfile + mmap), answering GEBN with the path
and geometry. From then on the client writes the EXACT GEB7/GEB8
(or GEB2/GEB4/GEBC/GEBT) frame bytes into the client->server ring and
a bridge-side reader thread feeds them through the full FrameService
core — `serve_frame_bytes`, so the shed screen, stage clock, tracing,
drain/GEBR refusals, and frame accounting are byte-for-byte the TCP
doors' (the lane cannot drift). Responses ride the server->client
ring back.

Layout (one file, header page + two rings):

    0     u32  magic 'GSM1'            4    u32  version
    8     u64  c2s capacity (bytes)    16   u64  s2c capacity
    24    u32  server flags            28   u32  client flags
    64    u64  c2s head   (client-written, monotonic byte count)
    72    u32  c2s seq    (wake word: bumped per c2s publish)
    128   u64  c2s tail   (server-written)
    136   u32  c2s space seq (bumped per c2s consume)
    192   u64  s2c head   256 u64 s2c tail  (mirrored, server->client)
    200   u32  s2c seq    264 u32 s2c space seq
    4096  c2s data[c2s_cap] | s2c data[s2c_cap]

Each record is `u32 length | frame bytes`, wrapping. Head/tail are
monotonic u64 byte counters (position = counter % capacity), each
written by exactly ONE side, so no cross-process locks exist anywhere
on the hot path. Every header word is loaded and stored whole, as one
aligned machine word (little-endian hosts), so a peer never reads one
half-written. Credit-window backpressure is the ring capacity
itself: a writer that finds no room simply doesn't publish (the client
falls back to the control socket for that frame; the server waits,
bounded, for the client to drain).

Wakeups: by default a real futex on the seq words (ctypes syscall —
FUTEX_WAIT/WAKE on the SHARED mapping, i.e. without FUTEX_PRIVATE), so
an idle lane costs no CPU. `GUBER_SHM_POLL_US > 0` switches to a
bounded-sleep busy poll with that cap instead (for kernels/arches
where the raw syscall is unavailable the poll path is the automatic
fallback). Every wait is timeout-bounded, so a lost wake or a lying
peer degrades to polling — correctness never depends on the wakeup.

Trust & teardown: the lane hangs off the edge bridge's unix socket,
the same trust tier as a co-located edge — but a buggy or hostile peer
process must still never wedge or crash the bridge. Every index and
length read from the mapping is validated (head-tail delta within
capacity, record length within the door's payload bound and inside the
published region); any violation tears down THAT session only: the
server marks its CLOSED flag, closes the control connection, unmaps,
and unlinks. Concurrent TCP/unix-stream connections are untouched.
A torn lane on the client side surfaces as a connection loss
(in-flight delivery unknown — the module's at-most-once stance), and
the next call reconnects over the socket and may re-negotiate.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import mmap
import os
import platform
import struct
import tempfile
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("gubernator_tpu_torch.shm")

__all__ = [
    "ShmError",
    "ShmProtocolError",
    "ShmTornError",
    "ShmRing",
    "ShmClientLane",
    "ShmServerSession",
    "open_server_session",
    "MAGIC_SHM_REQ",
    "MAGIC_SHM_OK",
    "HELLO_SHM",
    "DEFAULT_RING_KIB",
]

SHM_MAGIC = 0x314D5347  # 'GSM1'
SHM_VERSION = 1

#: control-socket negotiation (after the GEBI hello): the client sends
#: `u32 GEBM | u32 ring_kib_hint` (0 = server default; a smaller hint
#: shrinks the ring); the server replies `u32 GEBN | u32 path_len`
#: followed, when path_len > 0, by `u64 c2s_cap | u64 s2c_cap | path`.
#: path_len 0 means refused (capability withdrawn, draining, or
#: creation failed) — the connection continues on the socket.
MAGIC_SHM_REQ = 0x4D424547  # 'GEBM'
MAGIC_SHM_OK = 0x4E424547  # 'GEBN'

#: hello flags bit 5 (r18): this connection may negotiate the
#: shared-memory lane (advertised on unix-socket connections of an
#: shm-enabled FrameService only — same-host is a precondition)
HELLO_SHM = 32

#: mirror of edge_bridge.MAGIC_STALE / DRAIN_FRAME_ID (this module is
#: deliberately stdlib-only so the torch-free client can import it)
_MAGIC_STALE = 0x52424547
_DRAIN_FRAME_ID = 0xFFFFFFFF

HEADER_BYTES = 4096
DEFAULT_RING_KIB = 1024
MIN_RING_KIB = 64
MAX_RING_KIB = 1 << 20  # 1 GiB per direction

_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_C2S_CAP = 8
_OFF_S2C_CAP = 16
_OFF_SERVER_FLAGS = 24
_OFF_CLIENT_FLAGS = 28
FLAG_CLOSED = 1
FLAG_DRAINING = 2

_OFF_C2S_HEAD = 64
_OFF_C2S_SEQ = 72
_OFF_C2S_TAIL = 128
_OFF_C2S_SPACE_SEQ = 136
_OFF_S2C_HEAD = 192
_OFF_S2C_SEQ = 200
_OFF_S2C_TAIL = 256
_OFF_S2C_SPACE_SEQ = 264
_DATA_OFF = HEADER_BYTES

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

#: bound on any single wait: a lost futex wake (or a peer that lies
#: about its seq word) degrades to a poll at this cadence, never a hang
MAX_WAIT_S = 0.05


class ShmError(Exception):
    """Shared-memory lane error (generic / sizing)."""


class ShmProtocolError(ShmError):
    """The peer's ring state is invalid (lying indices, oversized or
    torn records): tear down the session, serve nothing more from it."""


class ShmTornError(ShmError):
    """The lane is gone (peer closed, mapping released)."""


# -- futex (ctypes, shared-mapping wakeups) ----------------------------------

_FUTEX_WAIT = 0
_FUTEX_WAKE = 1
_SYS_FUTEX = {"x86_64": 202, "aarch64": 98}.get(platform.machine())
_libc = None
_futex_ok: Optional[bool] = None


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def futex_supported() -> bool:
    """True when the raw futex syscall is usable (probed once): the
    wakeup tier. False falls back to bounded-sleep polling."""
    global _libc, _futex_ok
    if _futex_ok is None:
        try:
            if _SYS_FUTEX is None:
                raise OSError("no futex syscall number for this arch")
            _libc = ctypes.CDLL(None, use_errno=True)
            _libc.syscall.restype = ctypes.c_long
            # probe: FUTEX_WAKE on a private word must not fault
            word = ctypes.c_uint32(0)
            rc = _libc.syscall(
                _SYS_FUTEX,
                ctypes.byref(word),
                _FUTEX_WAKE,
                1,
                None,
                None,
                0,
            )
            _futex_ok = rc >= 0
        except Exception:
            _futex_ok = False
        if not _futex_ok:
            log.info("futex unavailable; shm lanes will poll")
    return _futex_ok


class ShmRing:
    """Both directions of one mapped lane file. Exactly one process
    calls create() (the server — it also unlinks at release) and one
    open()s the path. Index words are single-writer by contract; all
    loads of PEER-written words are validated before use."""

    def __init__(self, path: str, mm, created: bool, poll_us: int = 0):
        self.path = path
        self._mm = mm
        self.created = created
        self.poll_us = max(0, int(poll_us))
        self._released = False
        self._use_futex = self.poll_us <= 0 and futex_supported()
        # ctypes view pinning the buffer (futex needs a real address);
        # released before close — see release()
        self._cbuf = (ctypes.c_char * len(mm)).from_buffer(mm)
        self._base = ctypes.addressof(self._cbuf)
        # the header's index, seq and flag words as aligned machine
        # words: each load and store is one instruction, so the peer
        # never sees a half-written word (struct.pack_into zeroes the
        # field before it writes it, and packs byte by byte). The views
        # pin the buffer too, so close() cannot unmap under a reader.
        self._h32 = (ctypes.c_uint32 * (HEADER_BYTES // 4)).from_buffer(mm)
        self._h64 = (ctypes.c_uint64 * (HEADER_BYTES // 8)).from_buffer(mm)
        self.c2s_cap = self._u64(_OFF_C2S_CAP)
        self.s2c_cap = self._u64(_OFF_S2C_CAP)

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls, ring_kib: int, dir: Optional[str] = None, poll_us: int = 0
    ) -> "ShmRing":
        kib = max(MIN_RING_KIB, min(int(ring_kib), MAX_RING_KIB))
        cap = kib * 1024
        total = HEADER_BYTES + 2 * cap
        fd, path = tempfile.mkstemp(prefix="guber-shm-", dir=dir)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        except Exception:
            os.close(fd)
            os.unlink(path)
            raise
        os.close(fd)
        _U32.pack_into(mm, _OFF_MAGIC, SHM_MAGIC)
        _U32.pack_into(mm, _OFF_VERSION, SHM_VERSION)
        _U64.pack_into(mm, _OFF_C2S_CAP, cap)
        _U64.pack_into(mm, _OFF_S2C_CAP, cap)
        return cls(path, mm, True, poll_us)

    @classmethod
    def open(cls, path: str, poll_us: int = 0) -> "ShmRing":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size < HEADER_BYTES:
                raise ShmProtocolError(f"shm file too small ({size}B)")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic = _U32.unpack_from(mm, _OFF_MAGIC)[0]
        version = _U32.unpack_from(mm, _OFF_VERSION)[0]
        c2s = _U64.unpack_from(mm, _OFF_C2S_CAP)[0]
        s2c = _U64.unpack_from(mm, _OFF_S2C_CAP)[0]
        if magic != SHM_MAGIC or version != SHM_VERSION:
            mm.close()
            raise ShmProtocolError(
                f"bad shm header {magic:#x}/v{version}"
            )
        if (
            not (MIN_RING_KIB * 1024 <= c2s <= MAX_RING_KIB * 1024)
            or not (MIN_RING_KIB * 1024 <= s2c <= MAX_RING_KIB * 1024)
            or HEADER_BYTES + c2s + s2c != size
        ):
            mm.close()
            raise ShmProtocolError("shm geometry/file-size mismatch")
        return cls(path, mm, False, poll_us)

    # -- raw accessors -------------------------------------------------------

    def _u32(self, off: int) -> int:
        h = self._h32
        if h is None:
            raise ShmTornError("mapping released")
        return h[off >> 2]

    def _u64(self, off: int) -> int:
        h = self._h64
        if h is None:
            raise ShmTornError("mapping released")
        return h[off >> 3]

    def _put_u32(self, off: int, v: int) -> None:
        h = self._h32
        if h is None:
            raise ShmTornError("mapping released")
        h[off >> 2] = v & 0xFFFFFFFF

    def _put_u64(self, off: int, v: int) -> None:
        h = self._h64
        if h is None:
            raise ShmTornError("mapping released")
        h[off >> 3] = v & 0xFFFFFFFFFFFFFFFF

    # -- flags ---------------------------------------------------------------

    def server_flags(self) -> int:
        return self._u32(_OFF_SERVER_FLAGS)

    def client_flags(self) -> int:
        return self._u32(_OFF_CLIENT_FLAGS)

    def mark_closed(self, server_side: bool) -> None:
        off = _OFF_SERVER_FLAGS if server_side else _OFF_CLIENT_FLAGS
        try:
            self._put_u32(off, self._u32(off) | FLAG_CLOSED)
        except ShmTornError:
            return
        # wake every waiter in both directions so the peer notices now
        for seq in (
            _OFF_C2S_SEQ,
            _OFF_C2S_SPACE_SEQ,
            _OFF_S2C_SEQ,
            _OFF_S2C_SPACE_SEQ,
        ):
            self._bump_wake(seq)

    # -- wakeups -------------------------------------------------------------

    def _bump_wake(self, seq_off: int) -> None:
        try:
            self._put_u32(seq_off, self._u32(seq_off) + 1)
        except ShmTornError:
            return
        if self._use_futex:
            _libc.syscall(
                _SYS_FUTEX,
                ctypes.c_void_p(self._base + seq_off),
                _FUTEX_WAKE,
                0x7FFFFFFF,
                None,
                None,
                0,
            )

    def seq(self, seq_off: int) -> int:
        return self._u32(seq_off)

    def wait(self, seq_off: int, seen: int, timeout: float) -> None:
        """Block until the seq word moves past `seen`, the timeout
        expires, or — futex tier — a wake lands. Always bounded."""
        timeout = min(max(timeout, 0.0005), MAX_WAIT_S)
        if self._use_futex:
            ts = _Timespec(
                int(timeout), int((timeout - int(timeout)) * 1e9)
            )
            _libc.syscall(
                _SYS_FUTEX,
                ctypes.c_void_p(self._base + seq_off),
                _FUTEX_WAIT,
                ctypes.c_uint32(seen & 0xFFFFFFFF),
                ctypes.byref(ts),
                None,
                0,
            )
        else:
            time.sleep(min(timeout, max(self.poll_us, 1) / 1e6))

    # -- ring I/O ------------------------------------------------------------

    def _copy_in(self, base: int, cap: int, pos: int, data) -> None:
        i = pos % cap
        first = min(len(data), cap - i)
        try:
            self._mm[base + i : base + i + first] = data[:first]
            if first < len(data):
                self._mm[base : base + len(data) - first] = data[first:]
        except ValueError:
            raise ShmTornError("mapping released") from None

    def _copy_out(self, base: int, cap: int, pos: int, n: int) -> bytes:
        i = pos % cap
        first = min(n, cap - i)
        try:
            out = self._mm[base + i : base + i + first]
            if first < n:
                out += self._mm[base : base + n - first]
        except ValueError:
            raise ShmTornError("mapping released") from None
        return out

    def _try_write(
        self, head_off, tail_off, seq_off, base, cap, frame
    ) -> bool:
        need = 4 + len(frame)
        if len(frame) == 0 or need > cap:
            raise ShmError(
                f"{len(frame)}-byte frame cannot ride a {cap}-byte ring"
            )
        head = self._u64(head_off)
        tail = self._u64(tail_off)
        used = head - tail
        if not 0 <= used <= cap:
            raise ShmProtocolError(
                f"ring indices out of bounds (head {head}, tail {tail})"
            )
        if cap - used < need:
            return False
        self._copy_in(base, cap, head, _U32.pack(len(frame)))
        self._copy_in(base, cap, head + 4, frame)
        # publish AFTER the bytes land; the wake syscall is the write
        # barrier for the futex tier, the bounded poll covers the rest
        self._put_u64(head_off, head + need)
        self._bump_wake(seq_off)
        return True

    def _try_read(
        self, head_off, tail_off, space_seq_off, base, cap, max_len
    ) -> Optional[bytes]:
        head = self._u64(head_off)
        tail = self._u64(tail_off)
        if head == tail:
            return None
        used = head - tail
        if not 0 < used <= cap:
            raise ShmProtocolError(
                f"lying ring indices (head {head}, tail {tail}, "
                f"cap {cap})"
            )
        if used < 4:
            raise ShmProtocolError("torn record header")
        (ln,) = _U32.unpack(self._copy_out(base, cap, tail, 4))
        if ln == 0 or ln > max_len:
            raise ShmProtocolError(
                f"record length {ln} outside (0, {max_len}]"
            )
        if 4 + ln > used:
            # an honest writer publishes head only after the whole
            # record landed — a length past the published region is a
            # torn or hostile write
            raise ShmProtocolError(
                f"record length {ln} beyond published head"
            )
        data = self._copy_out(base, cap, tail + 4, ln)
        self._put_u64(tail_off, tail + 4 + ln)
        self._bump_wake(space_seq_off)
        return data

    # client -> server direction
    def write_c2s(self, frame: bytes) -> bool:
        return self._try_write(
            _OFF_C2S_HEAD, _OFF_C2S_TAIL, _OFF_C2S_SEQ,
            _DATA_OFF, self.c2s_cap, frame,
        )

    def read_c2s(self, max_len: int) -> Optional[bytes]:
        return self._try_read(
            _OFF_C2S_HEAD, _OFF_C2S_TAIL, _OFF_C2S_SPACE_SEQ,
            _DATA_OFF, self.c2s_cap, max_len,
        )

    # server -> client direction
    def write_s2c(self, frame: bytes) -> bool:
        return self._try_write(
            _OFF_S2C_HEAD, _OFF_S2C_TAIL, _OFF_S2C_SEQ,
            _DATA_OFF + self.c2s_cap, self.s2c_cap, frame,
        )

    def read_s2c(self, max_len: int) -> Optional[bytes]:
        return self._try_read(
            _OFF_S2C_HEAD, _OFF_S2C_TAIL, _OFF_S2C_SPACE_SEQ,
            _DATA_OFF + self.c2s_cap, self.s2c_cap, max_len,
        )

    # -- teardown ------------------------------------------------------------

    def release(self) -> None:
        """Unmap (and, creator side, unlink). Idempotent. The ctypes
        views pin the buffer, so they are dropped first; a transient
        BufferError (another thread mid-copy) retries briefly — worst
        case the mapping leaks for the process lifetime, never a
        crash."""
        if self._released:
            return
        self._released = True
        self._cbuf = self._h32 = self._h64 = None
        for _ in range(200):
            try:
                self._mm.close()
                break
            except BufferError:
                time.sleep(0.005)
        else:
            log.warning("shm mapping still referenced; leaking it")
        if self.created:
            try:
                os.unlink(self.path)
            except OSError:
                pass


# -- server session ----------------------------------------------------------


class ShmServerSession:
    """Bridge side of one lane: a reader thread pops request frames
    from the c2s ring and schedules them onto the service's event loop
    through `FrameService.serve_frame_bytes` (full core semantics);
    responses are written back to the s2c ring from the loop.
    Concurrency is bounded at the service's credit window. A GEBR
    refusal (drain or stale ring) keeps exact socket parity: every
    frame already in flight is answered through the ring FIRST, then
    the GEBR lands and the lane closes."""

    def __init__(
        self,
        service,
        ring: ShmRing,
        loop: asyncio.AbstractEventLoop,
        on_close: Optional[Callable[[], None]] = None,
    ):
        self.service = service
        self.ring = ring
        self.loop = loop
        self.on_close = on_close
        self._sem = threading.BoundedSemaphore(service.window)
        self._pending: set = set()  # loop-thread confined
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._read_loop, name="guber-shm-serve", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    # -- reader thread -------------------------------------------------------

    def _read_loop(self) -> None:
        ring = self.ring
        max_len = self.service.max_payload + 64  # frame header slack
        try:
            while not self._stop.is_set():
                try:
                    seen = ring.seq(_OFF_C2S_SEQ)
                    frame = ring.read_c2s(max_len)
                except ShmProtocolError as e:
                    log.warning(
                        "hostile/torn shm ring (%s): closing the lane",
                        e,
                    )
                    self._count_teardown()
                    break
                except ShmTornError:
                    break
                if frame is None:
                    if (
                        ring.client_flags() & FLAG_CLOSED
                        or ring.server_flags() & FLAG_CLOSED
                    ):
                        break
                    ring.wait(_OFF_C2S_SEQ, seen, MAX_WAIT_S)
                    continue
                # credit gate: bounds frames concurrently in service,
                # released from the loop when each one completes
                while not self._sem.acquire(timeout=MAX_WAIT_S):
                    if self._stop.is_set():
                        return
                try:
                    self.loop.call_soon_threadsafe(self._spawn, frame)
                except RuntimeError:
                    break  # loop is closing
        finally:
            self._stop.set()
            try:
                self.loop.call_soon_threadsafe(self.close)
            except RuntimeError:
                pass
            # grace for in-flight responses, then the thread — the
            # mapping's last user — releases it
            deadline = time.monotonic() + 2.0
            while self._pending and time.monotonic() < deadline:
                time.sleep(0.01)
            ring.release()

    # -- loop side -----------------------------------------------------------

    def _spawn(self, frame: bytes) -> None:
        if self._closed:
            self._sem.release()
            return
        task = self.loop.create_task(self._serve_one(frame))
        self._pending.add(task)

        def _done(t):
            self._pending.discard(t)
            self._sem.release()

        task.add_done_callback(_done)

    @staticmethod
    def _count_teardown() -> None:
        try:  # lazy: keep the module importable stdlib-only
            from gubernator_tpu_torch.serve import metrics

            metrics.GEB_SHM_TEARDOWNS.inc()
        except Exception:
            pass

    async def _serve_one(self, frame: bytes) -> None:
        try:
            resp = await self.service.serve_frame_bytes(frame)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a malformed frame poisons a stream door's connection;
            # here it poisons the lane — never the process
            log.warning("shm frame failed (%s): closing the lane", e)
            self._count_teardown()
            self.close()
            return
        try:
            from gubernator_tpu_torch.serve import metrics

            metrics.GEB_SHM_FRAMES.inc()
        except Exception:
            pass
        try:
            if (
                len(resp) >= 8
                and _U32.unpack_from(resp, 0)[0] == _MAGIC_STALE
            ):
                # drain or stale-ring refusal: answer every frame
                # already in flight first (socket parity — no accepted
                # frame is lost), then land the GEBR and close
                others = [
                    t
                    for t in self._pending
                    if t is not asyncio.current_task()
                ]
                if others:
                    await asyncio.gather(
                        *others, return_exceptions=True
                    )
                await self._write_resp(resp)
                self.close()
                return
            await self._write_resp(resp)
        except ShmError:
            self._count_teardown()
            self.close()

    async def _write_resp(self, resp: bytes) -> None:
        ring = self.ring
        deadline = self.loop.time() + 5.0
        while not self._closed:
            if ring.write_s2c(resp):
                return
            # ring full: bounded wait for the client to drain; a client
            # that stopped draining (or died) tears the lane down
            if ring.client_flags() & FLAG_CLOSED:
                raise ShmTornError("client closed the lane")
            if self.loop.time() > deadline:
                log.warning(
                    "shm client stopped draining responses; closing"
                )
                raise ShmTornError("response ring stayed full")
            await asyncio.sleep(0.001)

    def close(self) -> None:
        """Idempotent teardown (loop thread): mark the server CLOSED
        flag (the client's reader sees it and fails over), stop the
        reader thread, close the control connection. The reader thread
        unmaps/unlinks on its way out."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            self.ring.mark_closed(server_side=True)
        except ShmError:
            pass
        if self.on_close is not None:
            try:
                self.on_close()
            except Exception:
                pass


def open_server_session(service, ring_kib_hint: int, writer):
    """Negotiate one lane for a control connection: create the ring
    file, start the session, and return (session, GEBN reply bytes).
    The hint can only SHRINK the server-configured ring. Raises on
    creation failure (the caller answers a refusal instead)."""
    kib = int(getattr(service, "shm_ring_kib", DEFAULT_RING_KIB) or
              DEFAULT_RING_KIB)
    if ring_kib_hint:
        kib = min(kib, int(ring_kib_hint))
    kib = max(MIN_RING_KIB, min(kib, MAX_RING_KIB))
    poll_us = int(getattr(service, "shm_poll_us", 0) or 0)
    ring = ShmRing.create(kib, poll_us=poll_us)
    loop = asyncio.get_running_loop()
    sess = ShmServerSession(
        service, ring, loop, on_close=writer.close
    )
    try:
        from gubernator_tpu_torch.serve import metrics

        metrics.GEB_SHM_SESSIONS.inc()
    except Exception:
        pass
    path = ring.path.encode()
    reply = (
        struct.pack("<II", MAGIC_SHM_OK, len(path))
        + struct.pack("<QQ", ring.c2s_cap, ring.s2c_cap)
        + path
    )
    sess.start()
    return sess, reply


def shm_refusal() -> bytes:
    """The GEBN refusal reply (path_len 0): capability withdrawn for
    this request — the connection continues on the socket."""
    return struct.pack("<II", MAGIC_SHM_OK, 0)


# -- client lane -------------------------------------------------------------


class ShmClientLane:
    """Client side of one negotiated lane: `try_send` writes a request
    frame into the c2s ring (False = no room right now or the frame is
    too large for the lane — the caller falls back to the socket), and
    a reader thread drains s2c response frames into `on_frame` on the
    client's event loop. Any protocol violation or a server CLOSED
    flag fires `on_torn` once and the lane is dead."""

    #: request frames are bounded to a fraction of the ring so
    #: responses (which can be larger than their requests — varlen
    #: error/owner fields) always have room to come back
    FRAME_FRACTION = 4

    def __init__(self, path: str, poll_us: int = 0):
        self.ring = ShmRing.open(path, poll_us=poll_us)
        self.frame_bound = (
            min(self.ring.c2s_cap, self.ring.s2c_cap)
            // self.FRAME_FRACTION
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._on_frame = None
        self._on_torn = None
        self._stop = threading.Event()
        self._torn = False
        self._thread: Optional[threading.Thread] = None

    def start(self, loop, on_frame, on_torn, max_resp_len: int) -> None:
        self._loop = loop
        self._on_frame = on_frame
        self._on_torn = on_torn
        self._max_resp = max_resp_len
        self._thread = threading.Thread(
            target=self._read_loop, name="guber-shm-client", daemon=True
        )
        self._thread.start()

    def try_send(self, frame: bytes) -> bool:
        if self._torn or self._stop.is_set():
            return False
        if 4 + len(frame) > self.frame_bound:
            return False
        try:
            if self.ring.server_flags() & FLAG_CLOSED:
                self._fire_torn(ShmTornError("server closed the lane"))
                return False
            return self.ring.write_c2s(frame)
        except ShmError as e:
            self._fire_torn(e)
            return False

    def _fire_torn(self, exc: Exception) -> None:
        if self._torn:
            return
        self._torn = True
        self._stop.set()
        loop, cb = self._loop, self._on_torn
        if loop is not None and cb is not None:
            try:
                loop.call_soon_threadsafe(cb, exc)
            except RuntimeError:
                pass

    def _read_loop(self) -> None:
        ring = self.ring
        try:
            while not self._stop.is_set():
                try:
                    seen = ring.seq(_OFF_S2C_SEQ)
                    frame = ring.read_s2c(self._max_resp)
                except ShmError as e:
                    self._fire_torn(e)
                    break
                if frame is None:
                    if ring.server_flags() & FLAG_CLOSED:
                        self._fire_torn(
                            ShmTornError("server closed the lane")
                        )
                        break
                    if self._stop.is_set():
                        break
                    ring.wait(_OFF_S2C_SEQ, seen, MAX_WAIT_S)
                    continue
                try:
                    self._loop.call_soon_threadsafe(
                        self._on_frame, frame
                    )
                except RuntimeError:
                    break
        finally:
            try:
                ring.mark_closed(server_side=False)
            except ShmError:
                pass
            ring.release()

    def close(self) -> None:
        """Idempotent: mark the client CLOSED flag (the server reaps
        the session) and stop the reader, which unmaps on exit."""
        self._stop.set()
        try:
            self.ring.mark_closed(server_side=False)
        except ShmError:
            pass
