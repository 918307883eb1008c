"""Multi-host mesh: one key-space mesh spread over several processes (the
PyTorch port of gubernator_tpu/parallel/multihost.py).

`MeshEngine` (parallel/sharded.py) shards the key space over the shards
of ONE process. This module spreads the same engine over several
processes, as BASELINE config 5 lays it out (4 hosts x 8 chips, a
hierarchical psum): process p holds the contiguous global shards
[p * per, (p + 1) * per) on its local devices, under the 2-D ("host",
"chip") policy of shape (processes, per) (ShardingPolicy.over_processes).
The collectives run in torch.distributed over gloo, on host buffers:
the in-process loop over a process's shards is the reference's ICI
stage, and what crosses processes (the packed response rows a decide
gathers to the leader, one owner-masked pre-reduced vector a process for
the GLOBAL sync and the promoter's reads) is its DCN leg, staged through
pinned host memory on a GPU.

Every process must post the same collectives in the same order (gloo
matches them by that order). Serving is request-driven on the leader
(process 0), so followers run a lockstep loop fed by a step pipe: before
each device step the leader broadcasts (kind, now, arrays) over plain
length-prefixed TCP, then runs the step itself, then waits for every
follower's ack; a follower runs the same step on its own shards and acks
once it has POSTED the step's collectives (never after waiting on the
leader's, or the two would wait on each other). Collectives are posted
on the submit thread in step order; the leader's fetch threads only
wait on a posted gather. The pipe is a trusted-cluster side channel like
the reference's insecure peer gRPC (reference peers.go:130-139); a
follower failure surfaces as a broken pipe and the cluster restarts
fresh, the documented state-loss contract (reference
architecture.md:5-11).
"""

from __future__ import annotations

import collections
import logging
import socket
import struct
import time
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.parallel.policy import CROSS_PROCESS_BACKEND

log = logging.getLogger("gubernator_tpu_torch.multihost")

# Wire format GMH2: a typed, gadget-free codec. GMH1 framed pickle, which
# hands arbitrary code execution to anything that can reach a follower's
# listen port — a strictly worse trust posture than the reference's
# insecure-but-parse-safe protobuf peer channel (reference
# peers.go:130-139). Step messages are only flat dicts of scalars, strings,
# int tuples, one nested config dict, and dense numpy arrays, so a
# six-tag TLV encoding covers the whole surface with no deserialization
# gadget: decode constructs nothing but bytes, ints, str, tuple, dict and
# whitelisted-dtype ndarrays.
_MAGIC = b"GMH2"

_T_NONE, _T_INT, _T_STR, _T_ARR, _T_TUPLE, _T_DICT = range(6)

# dtype whitelist — everything the step pipe ever carries. Explicit
# little-endian codes so a mixed-endian cluster fails loudly at the
# codec, not silently in the kernels.
_DTYPES = {
    0: np.dtype("<u8"),  # key_hash
    1: np.dtype("<i8"),  # hits/limit/duration/remaining/reset_time
    2: np.dtype("<i4"),  # algo
    3: np.dtype("|b1"),  # gnp/is_over
}
_DTYPE_CODES = {dt: code for code, dt in _DTYPES.items()}

_MAX_DEPTH = 4  # message dict -> config dict -> tuples; headroom of one
_MAX_ITEMS = 4096  # fields per dict / elements per tuple
_MAX_STR = 1 << 20
_MAX_ARR_BYTES = 1 << 31


def _encode_value(out: bytearray, v, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("step message nests too deep to encode")
    if v is None:
        out.append(_T_NONE)
    elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        out.append(_T_INT)
        out += struct.pack("<q", int(v))
    elif isinstance(v, str):
        b = v.encode()
        if len(b) > _MAX_STR:
            raise ValueError("string field too large for step pipe")
        out.append(_T_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, np.ndarray):
        dt = v.dtype.newbyteorder("<") if v.dtype.byteorder == ">" else v.dtype
        arr = np.ascontiguousarray(v, dtype=dt)
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise ValueError(f"dtype {arr.dtype} not in step-pipe whitelist")
        if arr.ndim > 4:
            raise ValueError("array rank > 4 on step pipe")
        out.append(_T_ARR)
        out.append(code)
        out.append(arr.ndim)
        for d in arr.shape:
            out += struct.pack("<I", d)
        out += arr.tobytes()
    elif isinstance(v, tuple):
        if len(v) > _MAX_ITEMS:
            raise ValueError("tuple too long for step pipe")
        out.append(_T_TUPLE)
        out += struct.pack("<I", len(v))
        for e in v:
            _encode_value(out, e, depth + 1)
    elif isinstance(v, dict):
        if len(v) > _MAX_ITEMS:
            raise ValueError("dict too large for step pipe")
        out.append(_T_DICT)
        out += struct.pack("<I", len(v))
        for k, e in v.items():
            kb = str(k).encode()
            out += struct.pack("<H", len(kb))
            out += kb
            _encode_value(out, e, depth + 1)
    else:
        raise ValueError(f"type {type(v).__name__} not encodable on step pipe")


def _utf8(raw) -> str:
    # keep the "hostile frame -> ConnectionError" contract airtight
    try:
        return str(raw, "utf-8")
    except UnicodeDecodeError as e:
        raise ConnectionError(f"invalid utf-8 in step pipe frame: {e}")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise ConnectionError("step pipe frame truncated")
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    def u8(self) -> int:
        return self.take(1)[0]

    def unpack(self, fmt: str):
        (v,) = struct.unpack("<" + fmt, self.take(struct.calcsize(fmt)))
        return v


def _decode_value(r: _Reader, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise ConnectionError("step pipe frame nests too deep")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_INT:
        return r.unpack("q")
    if tag == _T_STR:
        n = r.unpack("I")
        if n > _MAX_STR:
            raise ConnectionError("oversized string in step pipe frame")
        return _utf8(r.take(n))
    if tag == _T_ARR:
        dt = _DTYPES.get(r.u8())
        if dt is None:
            raise ConnectionError("unknown dtype in step pipe frame")
        ndim = r.u8()
        if ndim > 4:
            raise ConnectionError("array rank > 4 in step pipe frame")
        shape = tuple(r.unpack("I") for _ in range(ndim))
        n_elem = 1
        for d in shape:
            n_elem *= d
        if n_elem * dt.itemsize > _MAX_ARR_BYTES:
            raise ConnectionError("oversized array in step pipe frame")
        raw = r.take(n_elem * dt.itemsize)
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    if tag == _T_TUPLE:
        n = r.unpack("I")
        if n > _MAX_ITEMS:
            raise ConnectionError("oversized tuple in step pipe frame")
        return tuple(_decode_value(r, depth + 1) for _ in range(n))
    if tag == _T_DICT:
        n = r.unpack("I")
        if n > _MAX_ITEMS:
            raise ConnectionError("oversized dict in step pipe frame")
        d = {}
        for _ in range(n):
            klen = r.unpack("H")
            k = _utf8(r.take(klen))
            d[k] = _decode_value(r, depth + 1)
        return d
    raise ConnectionError(f"unknown tag {tag} in step pipe frame")


def _encode_msg(obj: dict) -> bytes:
    out = bytearray()
    _encode_value(out, obj)
    return _MAGIC + struct.pack("<Q", len(out)) + bytes(out)


def _send_msg(sock: socket.socket, obj: dict) -> None:
    sock.sendall(_encode_msg(obj))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("step pipe closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket) -> dict:
    if _recv_exact(sock, 4) != _MAGIC:
        raise ConnectionError("step pipe desync")
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if n > _MAX_ARR_BYTES:
        raise ConnectionError("oversized step pipe frame")
    r = _Reader(_recv_exact(sock, n))
    msg = _decode_value(r)
    if not isinstance(msg, dict):
        raise ConnectionError("step pipe frame is not a message dict")
    if r.pos != len(r.buf):
        raise ConnectionError("trailing bytes in step pipe frame")
    return msg


class StepPipe:
    """Leader side: broadcast each device step to every follower and wait
    for acks (the ack keeps processes in lockstep so no follower falls
    more than one collective behind)."""

    def __init__(self, follower_addrs: Sequence[str], timeout_s: float = 30.0):
        self.socks: List[socket.socket] = []
        for addr in follower_addrs:
            host, _, port = addr.rpartition(":")
            deadline = time.monotonic() + timeout_s
            while True:  # follower binds its listener after the
                # rendezvous; retry until it is up
                try:
                    s = socket.create_connection((host, int(port)), timeout=5)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            s.settimeout(None)  # connect timeout must not cap step acks
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.socks.append(s)

    def broadcast(self, msg: dict) -> None:
        wire = _encode_msg(msg)  # serialize once for every follower
        for s in self.socks:
            s.sendall(wire)

    def await_acks(self) -> None:
        for s in self.socks:
            m = _recv_msg(s)
            if m.get("kind") == "nack":
                raise RuntimeError(f"follower rejected step: {m.get('error')}")
            if m.get("kind") != "ack":
                raise RuntimeError(f"unexpected follower reply: {m}")

    def close(self) -> None:
        for s in self.socks:
            try:
                _send_msg(s, {"kind": "shutdown"})
                s.close()
            except OSError:
                pass


def initialize_distributed(
    coordinator: str, num_processes: int, process_id: int, timeout_s: float = 60.0
) -> None:
    """Join the process group: torch.distributed over gloo, rendezvous at
    `coordinator` ("host:port", hosted by process 0 as the JAX
    coordinator is). `timeout_s` bounds the rendezvous, so a process that
    never comes fails every other one with this message instead of a
    30-minute wait, and it bounds each collective after it."""
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend=CROSS_PROCESS_BACKEND,
            init_method=f"tcp://{coordinator}",
            world_size=num_processes,
            rank=process_id,
            timeout=timedelta(seconds=timeout_s),
        )
    except RuntimeError as e:  # DistStoreError and gloo's connect errors
        raise RuntimeError(
            f"process {process_id} of {num_processes} could not join the "
            f"process group at {coordinator} within {timeout_s:g} s: {e}"
        ) from e


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _inner(name: str, doc: str) -> property:
    """A wrapper attribute that reads and writes the inner engine's."""
    return property(
        lambda self: getattr(self.inner, name),
        lambda self, value: setattr(self.inner, name, value),
        doc=doc,
    )


class MultiHostMeshEngine:
    """The mesh engine (parallel/sharded.MeshEngine) over every process's
    shards, plus the leader's lockstep step pipe: this wrapper owns only
    the choreography (broadcast each device step so every process runs
    the same one); every decide/upsert/sync code path is the engine's.
    Construct it alike in every process; only the leader calls the
    public decide/update/sync methods, followers run follower_loop.

    In a process group (initialize_distributed), process p holds the
    global shards [p * per, (p + 1) * per) on `devices` (every local
    device of the default kind when None; a list may name one device
    more than once). Without one it is a one-process mesh over `devices`
    with no pipe, as the reference's is without jax.distributed.

    On a GPU each process decides its shards as one captured graph
    replay a device (MeshEngine's default), and so runs its installs,
    GLOBAL steps and reads: the lockstep warmup makes every process
    capture the same shapes in the same order, and a follower's steps
    replay them. A GLOBAL step or a read replays each process's charge
    (or read) graph, all_reduces the parts between the replays, and (a
    GLOBAL step) replays each process's install graph.
    """

    def __init__(
        self,
        store_config,
        followers: Optional[Sequence[str]] = None,
        buckets: Sequence[int] = (64, 256, 1024, 4096),
        sketch=None,
        devices: Optional[Sequence] = None,
    ):
        import torch.distributed as dist

        from gubernator_tpu_torch.parallel.policy import ShardingPolicy, local_devices
        from gubernator_tpu_torch.parallel.sharded import MeshEngine

        if devices is None:
            devices = local_devices()
        if dist.is_available() and dist.is_initialized():
            rank = dist.get_rank()
            policy = ShardingPolicy.over_processes(devices, rank, dist.get_world_size())
        else:
            rank = 0
            policy = ShardingPolicy.over_mesh(devices)
        self.is_leader = rank == 0
        self.inner = MeshEngine(store_config, buckets=buckets, sketch=sketch, policy=policy)
        # the steps a follower ran, by kind, and the decides among them
        # that dispatched (follower_loop counts both)
        self.steps = collections.Counter()
        self.decides = 0
        # the leader's lockstep cost: steps, the ms from each broadcast to
        # its last ack (the leader's own dispatch overlaps it), and the ms
        # of that spent blocked on the acks after its own dispatch
        self.pipe_stats = dict(steps=0, broadcast_to_ack_ms=0.0, ack_wait_ms=0.0)
        self._t_broadcast = 0.0
        self.pipe = (
            StepPipe(followers) if (self.is_leader and followers) else None
        )
        if self.pipe:
            # Config handshake: every process derives its batch padding
            # from its own ladder, and lockstep needs the shapes (and so
            # the collectives) IDENTICAL across processes; a mismatch
            # fails here on both sides instead of diverging mid-serving.
            try:
                self.pipe.broadcast({"kind": "hello", "config": self._config()})
                self.pipe.await_acks()
            except BaseException:
                self.pipe.close()
                raise

    def _config(self) -> dict:
        skc = self.inner.sketch_config
        return {
            "buckets": tuple(self.inner.buckets),
            "sub_buckets": tuple(self.inner.sub_buckets),
            "store": (self.inner.config.rows, self.inner.config.slots),
            "n_shards": self.inner.n,
            # the sketch geometry and counter width: a leader with the
            # cold tier and a follower without it (or with another
            # width or counter dtype) would diverge at the first
            # two-tier dispatch
            "sketch": (
                (skc.rows, skc.width, skc.counter_bytes)
                if skc is not None
                else None
            ),
        }

    @property
    def config(self):
        """The store geometry of every shard."""
        return self.inner.config

    @property
    def buckets(self):
        return self.inner.buckets

    @property
    def sub_buckets(self):
        return self.inner.sub_buckets

    @property
    def n(self):
        """The GLOBAL shard count (every process's)."""
        return self.inner.n

    @property
    def n_local(self):
        """The shards this process holds (its writebacks a step)."""
        return self.inner.n_local

    @property
    def devices(self):
        return self.inner.devices

    @property
    def device(self):
        return self.inner.device

    @property
    def policy(self):
        return self.inner.policy

    @property
    def device_span_ms(self):
        return self.inner.device_span_ms

    # this process's captured decides (MeshEngine.device_graphs)
    @property
    def graph_count(self):
        return self.inner.graph_count

    @property
    def graph_captures(self):
        return self.inner.graph_captures

    @property
    def graph_pool_bytes(self):
        return self.inner.graph_pool_bytes

    @property
    def capture_s(self):
        return self.inner.capture_s

    # and its captured installs, GLOBAL steps and reads
    @property
    def program_graph_count(self):
        return self.inner.program_graph_count

    @property
    def program_captures(self):
        return self.inner.program_captures

    @property
    def first_use_captures(self):
        return self.inner.first_use_captures

    @property
    def program_capture_s(self):
        return self.inner.program_capture_s

    def _graphs_warmed(self) -> None:
        """warmup_public's last step, on this process's graphs only (a
        follower's counts keep the warmup's captures)."""
        self.inner._graphs_warmed()

    # the counters warmup_public zeroes through the engine it is given
    stats = _inner("stats", "EngineStats of the decides the leader fetched")
    install_chunks = _inner("install_chunks", "window-install chunks in this process")
    gossip_chunks = _inner("gossip_chunks", "gossip-charge chunks in this process")
    warmup_launches = _inner("warmup_launches", "writebacks the last warmup made here")
    stages = _inner("stages", "the stage clock the leader's submit and fetch spans go to")

    @property
    def reset_generation(self):
        # store-wipe epoch for the over-limit shed cache; follower
        # stores reset in lockstep with the leader's, so the leader's
        # counter is authoritative for the whole mesh
        return self.inner.reset_generation

    # -- sketch cold tier surfaces --------------------------------------------
    # `sketch` gates the tier, `observe_hook` is the promoter's hot-key
    # observer (leader-local: only the leader dispatches request batches).
    # Both sides of a lockstep decide must pick the same two-tier-or-not
    # program, so the leader's `sketch_on` rides every decide message
    # ("sk") and followers adopt it before dispatching.

    @property
    def sketch(self):
        return self.inner.sketch

    @property
    def sketch_config(self):
        return self.inner.sketch_config

    @property
    def sketch_on(self):
        return self.inner.sketch_on

    @sketch_on.setter
    def sketch_on(self, value):
        self.inner.sketch_on = value

    @property
    def observe_hook(self):
        return self.inner.observe_hook

    @observe_hook.setter
    def observe_hook(self, fn):
        self.inner.observe_hook = fn

    @property
    def collective_stats(self):
        return self.inner.collective_stats

    # -- leader API ---------------------------------------------------------

    def _lockstep(self, msg: dict) -> None:
        if self.pipe:
            self._t_broadcast = time.perf_counter()
            self.pipe.broadcast(msg)

    def _done(self) -> None:
        if self.pipe:
            t = time.perf_counter()
            self.pipe.await_acks()
            end = time.perf_counter()
            self.pipe_stats["steps"] += 1
            self.pipe_stats["broadcast_to_ack_ms"] += (end - self._t_broadcast) * 1e3
            self.pipe_stats["ack_wait_ms"] += (end - t) * 1e3

    def decide_arrays(self, key_hash, hits, limit, duration, algo, gnp, now):
        assert self.is_leader
        return self.decide_wait(
            self.decide_submit(key_hash, hits, limit, duration, algo, gnp, now)
        )

    def decide_submit(self, key_hash, hits, limit, duration, algo, gnp, now):
        """Broadcast the batch, dispatch this process's shards and post
        the gather of every shard's packed rows to the leader, then wait
        for the acks (each follower has posted its part of the gather).
        The leader may submit batch N+1 while batch N's gather is still
        in flight; decide_wait waits on it."""
        assert self.is_leader
        self._lockstep(
            {
                "kind": "decide",
                "key_hash": key_hash,
                "hits": hits,
                "limit": limit,
                "duration": duration,
                "algo": algo,
                "gnp": gnp,
                "now": now,
                "sk": int(self.inner.sketch_on),
            }
        )
        try:
            return self.inner.decide_submit(
                key_hash, hits, limit, duration, algo, gnp, now
            )
        finally:
            self._done()

    def decide_wait(self, handle):
        """Leader-local: waits on the batch's gather (posted at submit)
        and unpermutes; no step message."""
        assert self.is_leader
        return self.inner.decide_wait(handle)

    def prep_run(self, fields: dict) -> dict:
        """Leader-local arrival-time prep (serve/batcher.py): host work
        with no collective. Followers receive the already-sorted run in
        decide_submit_presorted's message and never re-sort."""
        assert self.is_leader
        return self.inner.prep_run(fields)

    def merge_prepped(self, runs):
        """The leader's merge of pre-sorted runs, in the FLAT merged form
        (serve/prep.py): it doubles as the lockstep wire format that
        decide_submit_merged broadcasts; each process derives the same
        [n_shards, B_sub] layout from it."""
        assert self.is_leader
        from gubernator_tpu_torch.serve.prep import merge_runs

        return merge_runs(runs)

    def decide_submit_merged(self, merged, now):
        """Dispatch a merge_prepped batch across the lockstep fleet."""
        return self.decide_submit_presorted(
            merged["fields"], merged["skey"], merged["order"],
            merged["counts"], now,
        )

    def decide_submit_presorted(self, fields, skey, order, counts, now):
        """The merge path's decide_submit: broadcasts the SORTED batch
        (fields, sort keys, per-shard counts), so followers skip the
        presort. `order` stays with the leader: it only unpermutes the
        responses, which followers never fetch."""
        assert self.is_leader
        msg = {"kind": "decide_p", "skey": skey, "counts": counts,
               "now": now, "sk": int(self.inner.sketch_on)}
        msg.update(fields)
        self._lockstep(msg)
        try:
            return self.inner.decide_submit_presorted(
                fields, skey, order, counts, now
            )
        finally:
            self._done()

    def update_globals(self, key_hash, limit, remaining, reset_time, is_over,
                       now=None):
        assert self.is_leader
        from gubernator_tpu_torch.api.types import millisecond_now

        now = millisecond_now() if now is None else now
        self._lockstep(
            {
                "kind": "upsert",
                "key_hash": key_hash,
                "limit": limit,
                "remaining": remaining,
                "reset_time": reset_time,
                "is_over": is_over,
                "now": now,
            }
        )
        try:
            return self.inner.update_globals(
                key_hash, limit, remaining, reset_time, is_over, now=now
            )
        finally:
            self._done()

    def reset(self) -> None:
        assert self.is_leader
        self._lockstep({"kind": "reset"})
        try:
            self.inner.reset()
        finally:
            self._done()

    def sync_globals(self, key_hash, limit, duration, now, algo=None):
        assert self.is_leader
        self._lockstep(
            {
                "kind": "sync",
                "key_hash": key_hash,
                "limit": limit,
                "duration": duration,
                "algo": algo,
                "now": now,
            }
        )
        try:
            return self.inner.sync_globals(
                key_hash, limit, duration, now, algo=algo
            )
        finally:
            self._done()

    def apply_global_hits(self, key_hash, hits, limit, duration, now,
                          algo=None):
        """Mesh-native GLOBAL flush: the hits charge their owner shards
        and the post-charge windows install on every other shard, in one
        lockstep step across every process. Its answers are the
        cross-process sum, so every process holds them; followers
        discard theirs."""
        assert self.is_leader
        n = key_hash.shape[0]
        if n == 0:
            z = np.empty(0, np.int64)
            return z, z, z, z
        self._lockstep(
            {
                "kind": "ghits",
                "key_hash": key_hash,
                "hits": hits,
                "limit": limit,
                "duration": duration,
                "algo": algo,
                "now": now,
            }
        )
        try:
            return self.inner.apply_global_hits(
                key_hash, hits, limit, duration, now, algo=algo
            )
        finally:
            self._done()

    def promote_from_sketch(self, key_hash, limits, durations, now=None):
        """Lockstep promotion: the serving tier's promoter stays a host
        loop on the leader, but its device steps (the owner-masked
        estimate and live-row reads, then the conditional install)
        broadcast so every process runs them. The branch on which keys to
        install cannot diverge: both reads are cross-process sums, the
        same in every process."""
        assert self.is_leader
        from gubernator_tpu_torch.api.types import millisecond_now

        now = millisecond_now() if now is None else now
        kh = np.ascontiguousarray(key_hash, np.uint64)
        limits = np.asarray(limits, np.int64)
        durations = np.asarray(durations, np.int64)
        if kh.shape[0] == 0 or self.inner.sketch is None:
            return self.inner.promote_from_sketch(kh, limits, durations, now)
        self._lockstep(
            {
                "kind": "promote",
                "key_hash": kh,
                "limits": limits,
                "durations": durations,
                "now": now,
            }
        )
        try:
            return self.inner.promote_from_sketch(kh, limits, durations, now)
        finally:
            self._done()

    def _warmup_sketch_reads(self, now) -> None:
        """The lockstep twin of the engine's promoter-read warmup
        (warmup_public calls it by name): each pow2 rung rides a
        `promote` step so followers run the same reads and installs. The
        installs dirty the store; warmup_public ends with a (broadcast)
        reset()."""
        if self.inner.sketch is None:
            return
        from gubernator_tpu_torch.parallel.sharded import READ_RUNGS

        for B in READ_RUNGS:
            kh = np.arange(1, B + 1, dtype=np.uint64) << np.uint64(32)
            self.promote_from_sketch(
                kh, np.full(B, 10, np.int64), np.full(B, 1000, np.int64),
                now,
            )

    def warmup(self, now: Optional[int] = None) -> None:
        """warmup_public through this wrapper, so every warmup step is
        broadcast."""
        from gubernator_tpu_torch.parallel.sharded import warmup_public

        warmup_public(self, now)

    def close(self) -> None:
        """Shut the step pipe and release this process's captured
        decides."""
        if self.pipe:
            self.pipe.close()
        self.inner.close()

    # -- follower API -------------------------------------------------------

    def follower_loop(self, listen_addr: str, ready_cb=None) -> None:
        """Serve lockstep steps until the leader shuts the pipe. Each
        message runs the step the leader runs, so the collectives line up;
        `steps` counts them by kind, `decides` the decides dispatched."""
        assert not self.is_leader
        host, _, port = listen_addr.rpartition(":")
        srv = socket.create_server((host, int(port)))
        if ready_cb:
            ready_cb()
        conn, peer = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        log.info("step pipe connected from %s", peer)
        sent = []  # this process's posted gathers of decide rows
        try:
            while True:
                msg = _recv_msg(conn)
                kind = msg.pop("kind")
                if kind == "shutdown":
                    break
                # the gathers of earlier steps: the leader posted its side
                # before it awaited their acks, so they complete
                for work in sent:
                    work.wait()
                sent.clear()
                self.steps[kind] += 1
                if kind == "hello":
                    want, have = msg["config"], self._config()
                    if want != have:
                        err = (
                            "leader/follower config mismatch (batch shapes "
                            f"would diverge in lockstep): leader={want} "
                            f"follower={have}"
                        )
                        # nack first so the leader's await_acks raises the
                        # diagnostic instead of an opaque closed-pipe error
                        _send_msg(conn, {"kind": "nack", "error": err})
                        raise RuntimeError(err)
                elif kind == "decide":
                    # submit only: responses are the leader's, so this
                    # process posts its part of the gather and moves on
                    sk = msg.pop("sk", None)
                    if sk is not None:
                        self.inner.sketch_on = bool(sk)
                    sent.append(self.inner.decide_submit(**msg)[-1])
                    self.decides += 1
                elif kind == "decide_p":
                    # merge-combined batch: already sorted and clipped on
                    # the leader; order=None (identity)
                    sk = msg.get("sk")
                    if sk is not None:
                        self.inner.sketch_on = bool(sk)
                    handle = self.inner.decide_submit_presorted(
                        {
                            k: msg[k]
                            for k in ("key_hash", "hits", "limit",
                                      "duration", "algo", "gnp")
                        },
                        msg["skey"],
                        None,
                        msg["counts"],
                        msg["now"],
                    )
                    if handle is not None:
                        sent.append(handle[-1])
                        self.decides += 1
                elif kind == "reset":
                    self.inner.reset()
                elif kind == "upsert":
                    self.inner.update_globals(
                        msg["key_hash"],
                        msg["limit"],
                        msg["remaining"],
                        msg["reset_time"],
                        msg["is_over"],
                        now=msg["now"],
                    )
                elif kind == "sync":
                    self.inner.sync_globals(
                        msg["key_hash"],
                        msg["limit"],
                        msg["duration"],
                        msg["now"],
                        algo=msg["algo"],
                    )
                elif kind == "ghits":
                    # the same charge-and-install step; its answers (the
                    # cross-process sum) are the leader's to fetch
                    self.inner._sync_padded(
                        msg["key_hash"],
                        msg["hits"],
                        msg["limit"],
                        msg["duration"],
                        msg["algo"],
                        msg["now"],
                    )
                elif kind == "promote":
                    # the reads are cross-process sums, so this process's
                    # install branch is the leader's
                    self.inner.promote_from_sketch(
                        msg["key_hash"],
                        msg["limits"],
                        msg["durations"],
                        msg["now"],
                    )
                else:
                    raise RuntimeError(f"unknown step kind {kind!r}")
                _send_msg(conn, {"kind": "ack"})
            for work in sent:
                work.wait()
        finally:
            conn.close()
            srv.close()
