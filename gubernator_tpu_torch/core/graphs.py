"""The engines' device programs as captured CUDA graphs: the port's
counterpart of the JAX package's jitted programs. Those are:

- the decide programs (gubernator_tpu/core/engine.py:72-101,
  `_decide_packed_jit`, `_decide_packed_sketch_jit` and
  `_decide_packed_chain_jit`), compiled at warmup
  (gubernator_tpu/parallel/sharded.py:2270-2284), and its mesh's
  shard_map programs `_step`, `_step_sketch` and `_step_chain`
  (:990-1043, compiled by `warmup_public`, :2302-2350);
- the window installs `upsert_globals_jit` and `upsert_windows_jit`
  (gubernator_tpu/core/kernels.py:1667-1685) and the mesh's `_upsert`
  and `_upsert_full` (parallel/sharded.py:1082-1105);
- the mesh's GLOBAL step `_sync` (`_shard_sync_globals`, :783-845,
  jitted :1070);
- the state reads `_rows_flat`, `_rows_sharded`, `_sketch_min_flat`,
  `_sketch_min_sharded` (:2364-2390) and the mesh's `_rows_coll` and
  `_sketch_min_coll` (:1046-1066);
- the promoter's top-k fold `_TOPK_UPDATE_JIT`
  (gubernator_tpu/serve/promoter.py:159).

Eager, one decide is ~870 torch launches whose Python dispatch keeps
the card idle most of a batch (PERF.md §5), and a mesh's GLOBAL step,
install or read is a Python loop of launches over its shards. Here each
(program, shapes) is captured ONCE into a `torch.cuda.CUDAGraph` and
every later call of that shape is one replay:

- **Rows.** One decide graph decides `k` rows, each on its own store
  (and sketch), in row order: the flat engine is k = 1; a mesh holds
  one `DeviceGraphs` a device whose k rows are the shards on that
  device, so a batch is one replay a device, as the reference's mesh is
  one shard_map program for all its shards. A mesh's install, GLOBAL
  step and read graphs likewise run every shard of their device, each
  masked by owner, from one set of inputs the shards share.
- **Static inputs.** A graph reads its inputs from one device byte
  buffer laid out by a `Layout`: `DecideLayout` (the BatchRequest [k,
  B], the BatchGroups [k, G], `now`, one 0-d int32 the decide reads on
  the device, and, for chains, `chain_id` [k, B]), `RequestLayout` (the
  GLOBAL step's BatchRequest and `now`), `InstallLayout` (an install
  chunk's padded columns, token or full lanes), `ReadLayout` (a read's
  key hashes and, for the sketch, its counter indices) and `TopKLayout`
  (a fold's keys and weights). The inputs are packed on the host into
  one pinned slot of a `StagingRing` and go up in ONE non-blocking copy
  into that buffer, on the caller's stream, in order before the replay.
  A mesh's GLOBAL install reads the cross-device sum from a static
  tensor instead (`DeviceGraphs.run(feed=...)`).
- **The ring.** A slot's bytes are being read by its copy until the
  copy has run on the card, so each slot records an event after its
  copy and the host waits on it before packing into the slot again. A
  slot still in flight when its turn comes makes the ring grow by one
  (up to `MAX_RING`), so the ring ends up as deep as the batches the
  caller keeps in flight.
- **State.** A capture bakes the store's, the sketch's and the top-k
  table's device pointers into the graph, so their owners update those
  tensors in place and never rebind them (reset, rebase, load_state,
  the installs and the top-k decay all write in place).
- **Capture** (`DeviceGraphs._capture`, on a shape's first use): the
  inputs are staged and the program captured on the capture's side
  stream (the device's, or the caller's own, as the top-k table's) into
  the set's one memory pool with `capture_error_mode="thread_local"`
  (another thread's pinned allocation or event wait does not abort it),
  then replayed once: that run is the call's answer. A program's first
  capture on a device is preceded by one eager run of the call on that
  stream instead (it is then the answer, and the capture records only),
  which loads the program's kernels and puts the allocator's blocks in
  place before anything records, as torch.cuda.graphs asks. Later
  shapes skip that run: a mesh's is k eager decides (~12-18 ms of host
  dispatch each on an H100) at each of up to 134 captures a warmup, and
  with it a mesh's captures took 1.5-1.8x as long (PERF.md §6). A cold
  capture risks a first use inside the capture (a kernel variant only a
  larger size picks, a lazy initialisation), which raises rather than
  record a wrong graph; tests/test_torch_cuda.py's
  test_every_serving_rung_captured_cold_replays_the_eager_decide_on_card
  replays every such pair of the serving ladder against the eager
  decide. A capture that fails, or whose program did not record exactly
  the `writeback_add` launches it must (one a row for a decide or an
  install, one a row for each half of a GLOBAL step, none for a read or
  the top-k fold), raises: nothing falls back to the eager program.
- **One capture at a time.** A capture is invalidated by a device-wide
  synchronize, or by the destruction of another CUDA graph, anywhere in
  the process while it runs, even with "thread_local" (measured on an
  H100: both abort it; a second engine's replays, pinned allocations,
  event waits and `empty_cache` in another thread do not). So every
  capture, every graph reset and the port's device-wide synchronizes
  (`synchronize`) hold one process-wide lock, captures run on one side
  stream a device drawn from the high-priority pool (the port's other
  side streams are default priority), the collector is off while a
  graph records, and the graphs of a `DeviceGraphs` dropped without
  `close()` are not destroyed by the collector but retired and reset
  at the next safe point under the lock.
- **Replays** of all of an engine's graphs on one device share one
  memory pool (`torch.cuda.graph_pool_handle()`). That is safe because
  every replay and every read of a graph's output (the packed D2H copy
  the engine enqueues right after the replay) run in order on that
  device's current stream: the next replay of any graph may overwrite
  that output only after the copy. The top-k table replays on its own
  stream, so it has a `DeviceGraphs`, and so a pool, of its own.
- **Counting.** A replay runs no Python, so `writeback_add`'s and the
  segmented scans' launch counts do not move by themselves: each replay
  adds the launches its capture recorded (`writeback.count_replay`,
  `scan.count_replay`), in `DeviceGraphs.replay`.
  A set counts its decides (`captures`, `replays`) apart from its other
  programs (`program_captures`, `program_replays`), and those apart from
  the captures of programs the reference too compiles only on first use
  (`first_use_captures`: the full-lane install, reads past the rungs a
  warmup walks).

Nothing here imports CUDA state or builds anything at import; the
layouts, the ring and the programs also run on the CPU (the tests hold
them there).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from gubernator_tpu_torch.core import scan, writeback
from gubernator_tpu_torch.core.engine import (
    decide_packed,
    decide_packed_chain,
    decide_packed_sketch,
)
from gubernator_tpu_torch.core.kernels import BatchGroups, BatchRequest

#: the decide programs, each (store, sketch, req, groups, now, chain_id)
#: -> the packed int32[4*B+4] output of one row (core.engine.pack_outputs)
PROGRAMS = {
    "exact": lambda store, sketch, req, groups, now, chain_id: decide_packed(
        store, req, now, groups)[1],
    "sketch": lambda store, sketch, req, groups, now, chain_id: decide_packed_sketch(
        store, sketch, req, now, groups)[2],
    "chain": lambda store, sketch, req, groups, now, chain_id: decide_packed_chain(
        store, req, now, groups, chain_id)[1],
}


def decide_rows(program: str, stores, sketches, rows) -> torch.Tensor:
    """`program` on each row, in order: row r's inputs (req, groups, now,
    chain_id) on stores[r] and sketches[r]. Returns the packed outputs
    as one int32[k, 4*B+4] (for k = 1 a view of the one output: the flat
    engine's graph records no copy)."""
    fn = PROGRAMS[program]
    outs = [fn(st, sk, *inp) for st, sk, inp in zip(stores, sketches, rows)]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


#: the most slots a StagingRing grows to
MAX_RING = 16

#: held by every capture, every graph reset and `synchronize`
_LOCK = threading.RLock()
#: the capture side stream of each device (captures are serialized)
_STREAMS: dict = {}
#: the graph dicts of DeviceGraphs the collector dropped, reset under
#: _LOCK at the next capture, close or synchronize
_RETIRED: list = []


def _reset_retired() -> None:
    """Destroy the retired graphs (the caller holds _LOCK)."""
    while _RETIRED:
        graphs = _RETIRED.pop()
        while graphs:
            graphs.popitem()[1].graph.reset()


def _retire_on_collect(owner, graphs: dict) -> None:
    """When `owner` is collected, keep its `graphs` alive in _RETIRED
    rather than let the collector destroy them, maybe inside a capture."""
    weakref.finalize(owner, _RETIRED.append, graphs)


def synchronize(device=None) -> None:
    """torch.cuda.synchronize(device), never while a program is being
    captured (a device-wide sync aborts a capture in any thread); also
    destroys the retired graphs."""
    with _LOCK:
        _reset_retired()
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _collector_off():
    """No cyclic collection (and so no finaliser) while a graph records."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


_TORCH_OF = {
    np.dtype(np.uint64): torch.int64,  # key hashes: int64 bit patterns
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}

#: the BatchRequest's fields, int64 first (a layout keeps 8-byte order)
_REQ_WIDE = [("req", "key_hash", np.uint64)]
_REQ_I32 = [("req", name, np.int32) for name in ("hits", "limit", "duration", "algo")]
_REQ_BOOL = [("req", "gnp", np.bool_), ("req", "valid", np.bool_)]


class Layout:
    """Where each input of one program lives in a graph's static byte
    buffer: every field [k, n] row-major (`now` once) at an 8-byte-aligned
    offset. `fields` are (part, name, dtype, n, offset); `pack_parts`
    writes a call's host arrays, `part_views` reads them back as tensor
    views of a buffer on the host or the card."""

    def __init__(self, fields, k: int = 1):
        self.k = k
        self.fields = []
        off = 0
        for part, name, dtype, n in fields:
            dtype = np.dtype(dtype)
            self.fields.append((part, name, dtype, n, off))
            off += -(-(self._rows(part) * n * dtype.itemsize) // 8) * 8
        self.nbytes = off

    def _rows(self, part: str) -> int:
        return 1 if part == "now" else self.k

    def pack_parts(self, out: np.ndarray, parts: dict) -> None:
        """Write one call into the uint8 array `out`: parts[part] is a
        NamedTuple or dict of the part's fields (by name), an array (a
        part of one field), or, for "now", the int32 engine-ms; each
        field [k, n] or, for k = 1, [n]."""
        for part, name, dtype, n, off in self.fields:
            rows = self._rows(part)
            src = parts[part]
            if part == "now":
                src = np.asarray([src], dtype)
            elif isinstance(src, dict):
                src = src[name]
            elif not isinstance(src, np.ndarray):
                src = getattr(src, name)
            shaped = src.shape == (rows, n) or (rows == 1 and src.shape == (n,))
            if not shaped or src.dtype != dtype:
                raise ValueError(f"{part}.{name}: {src.dtype}{list(src.shape)}, the layout "
                                 f"wants {dtype}[{rows}, {n}]")
            out[off:off + rows * n * dtype.itemsize].view(dtype).reshape(rows, n)[:] = src

    def part_views(self, buf: torch.Tensor, row: int = 0) -> dict:
        """{part: {name: tensor view of row `row` of buf}}, and "now" a
        0-d tensor: what a graph reads."""
        got: dict = {}
        for part, name, dtype, n, off in self.fields:
            start = off if part == "now" else off + row * n * dtype.itemsize
            t = buf[start:start + n * dtype.itemsize].view(_TORCH_OF[dtype])
            if part == "now":
                got["now"] = t[0]
            else:
                got.setdefault(part, {})[name] = t
        return got


class DecideLayout(Layout):
    """A decide's inputs for `k` rows of request rung B, group rung G
    and (chains) a chain_id column. k = 1 is the flat engine's layout."""

    def __init__(self, B: int, G: int, chain: bool, k: int = 1):
        self.B, self.G, self.chain = B, G, chain
        fields = [
            ("req", "key_hash", np.uint64, B),
            ("groups", "key_hash", np.uint64, G),
            ("req", "hits", np.int32, B),
            ("req", "limit", np.int32, B),
            ("req", "duration", np.int32, B),
            ("req", "algo", np.int32, B),
            ("groups", "leader_pos", np.int32, G),
            ("groups", "end_pos", np.int32, G),
            ("groups", "group_id", np.int32, B),
            ("now", "now", np.int32, 1),
        ]
        if chain:
            fields.append(("chain", "chain_id", np.int32, B))
        fields += [
            ("req", "gnp", np.bool_, B),
            ("req", "valid", np.bool_, B),
            ("groups", "valid", np.bool_, G),
        ]
        super().__init__(fields, k)

    def pack(self, out: np.ndarray, req, groups, now, chain_id=None) -> None:
        """Write one batch (numpy BatchRequest and BatchGroups of this
        layout's shapes, [k, n] or, for k = 1, [n]; `now` an int32
        engine-ms; chain_id int32 of the request's shape for chains)
        into the uint8 array `out`."""
        self.pack_parts(out, {"req": req, "groups": groups, "now": now, "chain": chain_id})

    def views(self, buf: torch.Tensor, row: int = 0):
        """(BatchRequest, BatchGroups, now 0-d int32, chain_id or None)
        of row `row`: tensor views into the byte buffer `buf`, what a
        graph reads."""
        got = self.part_views(buf, row)
        chain_id = got["chain"]["chain_id"] if self.chain else None
        return (BatchRequest(**got["req"]), BatchGroups(**got["groups"]), got["now"],
                chain_id)

    def rows(self, buf: torch.Tensor) -> list:
        """Every row's views (`views`), in order."""
        return [self.views(buf, r) for r in range(self.k)]


class RequestLayout(Layout):
    """A GLOBAL step's inputs: one padded BatchRequest of rung B (every
    shard of a device reads the same one) and `now`."""

    def __init__(self, B: int):
        self.B = B
        super().__init__([(p, n, d, B) for p, n, d in _REQ_WIDE + _REQ_I32]
                         + [("now", "now", np.int32, 1)]
                         + [(p, n, d, B) for p, n, d in _REQ_BOOL])

    def pack(self, out: np.ndarray, req, now) -> None:
        self.pack_parts(out, {"req": req, "now": now})

    def views(self, buf: torch.Tensor):
        """(BatchRequest, now 0-d int32) viewing `buf`."""
        got = self.part_views(buf)
        return BatchRequest(**got["req"]), got["now"]


#: an install chunk's columns, in pad_to_bucket's (and upsert's) order
INSTALL_COLUMNS = ("key_hash", "limit", "remaining", "reset_time", "is_over", "valid")
INSTALL_FULL_COLUMNS = ("key_hash", "limit", "remaining", "reset_time", "duration", "ts",
                        "flags", "valid")


class InstallLayout(Layout):
    """An install chunk's padded columns at rung B: the token-replica
    form (key, limit, remaining, reset, is_over, valid) or, `full`, the
    full lanes (key, limit, remaining, reset, duration, ts, flags,
    valid)."""

    def __init__(self, B: int, full: bool):
        self.B, self.full = B, full
        names = INSTALL_FULL_COLUMNS if full else INSTALL_COLUMNS
        self.names = names
        dtype = {"key_hash": np.uint64, "is_over": np.bool_, "valid": np.bool_}
        order = sorted(names, key=lambda c: -np.dtype(dtype.get(c, np.int32)).itemsize)
        super().__init__([("cols", c, dtype.get(c, np.int32), B) for c in order])

    def pack(self, out: np.ndarray, cols) -> None:
        """Write one chunk's columns (numpy, in this form's order)."""
        self.pack_parts(out, {"cols": dict(zip(self.names, cols))})

    def views(self, buf: torch.Tensor) -> tuple:
        """The columns as tensors viewing `buf`, in this form's order
        (upsert_globals' or upsert_windows' positional arguments)."""
        got = self.part_views(buf)["cols"]
        return tuple(got[c] for c in self.names)


class ReadLayout(Layout):
    """A state read's inputs at pow2 rung B: the key hashes and, for a
    sketch read (`sketch_rows` > 0), the counter indices int64[rows, B]
    (core.sketches.sketch_indices_np's)."""

    def __init__(self, B: int, sketch_rows: int = 0):
        self.B, self.sketch_rows = B, sketch_rows
        fields = [("read", "key_hash", np.uint64, B)]
        if sketch_rows:
            fields.append(("read", "idx", np.int64, sketch_rows * B))
        super().__init__(fields)

    def pack(self, out: np.ndarray, key_hash, idx=None) -> None:
        parts = {"key_hash": key_hash}
        if self.sketch_rows:
            parts["idx"] = idx.reshape(-1)
        self.pack_parts(out, {"read": parts})

    def views(self, buf: torch.Tensor):
        """(key hashes int64[B], idx int64[rows, B] or None) viewing `buf`."""
        got = self.part_views(buf)["read"]
        idx = got["idx"].view(self.sketch_rows, self.B) if self.sketch_rows else None
        return got["key_hash"], idx


class TopKLayout(Layout):
    """A top-k fold's batch: B keys (int64 bit patterns) and weights."""

    def __init__(self, B: int):
        self.B = B
        super().__init__([("batch", "kh", np.int64, B), ("batch", "w", np.int64, B)])

    def pack(self, out: np.ndarray, kh, w) -> None:
        self.pack_parts(out, {"batch": {"kh": kh, "w": w}})

    def views(self, buf: torch.Tensor):
        got = self.part_views(buf)["batch"]
        return got["kh"], got["w"]


class StagingRing:
    """Host byte slots of `nbytes` each (pinned on a GPU host) that a
    call's inputs are packed into and copied up from, in turn. On the
    card each slot records an event after its copy and is packed again
    only once that event has passed; a slot still in flight when its
    turn comes makes the ring grow by one slot, up to MAX_RING, after
    which the host waits on it."""

    def __init__(self, nbytes: int, pin: bool):
        self.nbytes = nbytes
        self.pin = pin
        self._slots = []  # [host uint8 tensor, event of its last copy (card only)]
        self._i = 0
        self.waits = 0  # times the host waited on a slot's copy

    def _acquire(self) -> list:
        if not self._slots:
            self._slots.append(self._new_slot())
        slot = self._slots[self._i]
        ev = slot[1]
        if ev is not None and not ev.query():
            if len(self._slots) < MAX_RING:
                slot = self._new_slot()
                self._slots.insert(self._i, slot)
            else:
                self.waits += 1
                ev.synchronize()
        self._i = (self._i + 1) % len(self._slots)
        return slot

    def _new_slot(self) -> list:
        return [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=self.pin),
                torch.cuda.Event() if self.pin else None]

    @property
    def depth(self) -> int:
        return len(self._slots)

    def upload(self, layout: Layout, dst: torch.Tensor, *args) -> None:
        """Pack one call (`layout.pack(out, *args)`) into the next slot
        and copy it into `dst` (a byte buffer of `layout` on the host or
        the card) on the current stream: non-blocking from a pinned
        slot, with the slot's event recorded after the copy."""
        if layout.nbytes > self.nbytes:
            raise ValueError(f"a batch of {layout.nbytes} bytes in a ring of {self.nbytes}")
        slot = self._acquire()
        host = slot[0][:layout.nbytes]
        layout.pack(host.numpy(), *args)
        dst[:layout.nbytes].copy_(host, non_blocking=self.pin)
        if slot[1] is not None:
            slot[1].record()


class CapturedGraph(NamedTuple):
    """One captured program: its inputs' layout (None for a fed one), its
    static input (the byte buffer the graph reads through the layout's
    views, or the fed tensor), the graph, its static output (a tensor, a
    tuple of tensors or None), the writeback launches one replay makes,
    whether it is a decide, and the segmented scans one replay makes."""

    layout: Optional[Layout]
    static: torch.Tensor
    graph: "torch.cuda.CUDAGraph"
    out: object
    launches: int
    decide: bool
    scans: int


def _record_stream(out, stream) -> None:
    for t in (out if isinstance(out, tuple) else (out,)):
        if isinstance(t, torch.Tensor):
            t.record_stream(stream)


class DeviceGraphs:
    """The captured programs of `rows` stores on one device (an engine's
    one store, or a mesh's shards on that device), one per (program,
    shapes), sharing one memory pool, captured on the device's capture
    stream (or on `stream`); `staging_bytes` sizes the staging slots at
    first (the ring grows with a bigger layout)."""

    def __init__(self, device: torch.device, staging_bytes: int, rows: int = 1,
                 stream=None):
        self.device = device
        self.rows = rows
        self.pool = torch.cuda.graph_pool_handle()
        with _LOCK:
            if stream is None:
                if device not in _STREAMS:
                    _STREAMS[device] = torch.cuda.Stream(device, priority=-1)
                stream = _STREAMS[device]
            self.stream = stream
        self.ring = StagingRing(staging_bytes, pin=True)
        self.graphs: dict = {}
        _retire_on_collect(self, self.graphs)
        self.warm: set = set()  # programs run eagerly on this device's capture stream
        # since the counts were zeroed: captures of decides (a program's
        # first on the device also decides eagerly), and their replays
        self.captures = 0
        self.replays = 0
        # the other programs' captures (those the warmup walks), their
        # replays, and the captures of programs the reference too
        # compiles only on first use (full installs, reads past the
        # walked rungs)
        self.program_captures = 0
        self.program_replays = 0
        self.first_use_captures = 0
        self.capture_s = 0.0  # the host seconds of every capture
        self.program_capture_s = 0.0  # of those, the non-decide programs'

    def run(self, key: tuple, record, args=(), layout=None, feed=None, launches: int = 0,
            decide: bool = False, first_use: bool = False):
        """Run the program `key` = (program name, shapes...) on the
        current stream: replay its graph, or on the key's first use
        capture it. `record(static)` runs the program on the static
        input: the byte buffer that `args` are uploaded into through
        `layout()` (a callable, called only to capture), or a tensor on
        this device that `feed` (on any device, or pinned on the host)
        is copied into before every replay. A capture must record `launches` writeback
        launches. Returns the program's output on the card; the caller
        reads it on the same stream before the next run."""
        g = self.graphs.get(key)
        if g is None:
            with _LOCK, torch.cuda.device(self.device):
                _reset_retired()
                return self._capture_locked(key, record, args, layout, feed, launches,
                                            decide, first_use)
        if g.layout is not None:
            self.ring.upload(g.layout, g.static, *args)
        elif feed is not None:
            g.static.copy_(feed, non_blocking=True)
        return self.replay(g)

    def decide(self, program: str, stores, sketches, req, groups, now,
               chain_id=None) -> torch.Tensor:
        """Decide one batch of `rows` rows (numpy BatchRequest /
        BatchGroups [rows, n], or [n] for one row; `now` the int32
        engine-ms; chain_id numpy int32 of the request's shape for
        "chain"), row r on stores[r] and sketches[r], on the current
        stream: replay its shape's graph or, on the shape's first use,
        capture it (the program's first capture on this device decides
        eagerly first; later shapes are captured and replayed).
        Returns the packed output [rows, 4*B+4] on the card; the caller
        reads it on the same stream before the next run."""
        B, G = int(req.key_hash.shape[-1]), int(groups.key_hash.shape[-1])
        rows = self.rows

        def layout():
            return DecideLayout(B, G, program == "chain", rows)

        def record(static):
            return decide_rows(program, stores, sketches, layout().rows(static))

        return self.run((program, B, G), record, (req, groups, now, chain_id), layout,
                        launches=rows, decide=True)

    def replay(self, g: CapturedGraph):
        """Launch one captured program on the current stream and count
        its writeback launches and scans."""
        g.graph.replay()
        writeback.count_replay(g.launches)
        scan.count_replay(g.scans)
        if g.decide:
            self.replays += 1
        else:
            self.program_replays += 1
        return g.out

    def _capture_locked(self, key, record, args, layout, feed, launches, decide,
                        first_use):
        program = key[0]
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        if layout is not None:
            layout = layout()
            static = torch.empty(layout.nbytes, dtype=torch.uint8, device=self.device)
            if layout.nbytes > self.ring.nbytes:
                # a rung past the ladder's top (a mesh extends its
                # sub-batch ladder on overflow): a ring of bigger slots
                # from here on; the old slots' copies keep their pinned
                # blocks alive
                self.ring = StagingRing(layout.nbytes, pin=True)
            self.ring.upload(layout, static, *args)
        else:
            static = torch.empty(feed.shape, dtype=feed.dtype, device=self.device)
            static.copy_(feed, non_blocking=True)
        s = self.stream
        s.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        warm = program not in self.warm
        try:
            with torch.cuda.stream(s):
                if warm:
                    # the program's warm run here, and this call's answer
                    answer = record(static)
                    self.warm.add(program)
                before = writeback.writeback_add.captured
                scans_before = scan.seg_scan.captured
                with _collector_off():
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        out = record(static)
                    finally:
                        graph.capture_end()
                recorded = writeback.writeback_add.captured - before
                scans = scan.seg_scan.captured - scans_before
                if recorded != launches:
                    raise RuntimeError(
                        f"graph {key}: its capture recorded {recorded} writeback "
                        f"launches, not {launches}"
                    )
                if not warm:
                    graph.replay()  # this call's answer
                    writeback.count_replay(recorded)
                    scan.count_replay(scans)
                    answer = out
        except BaseException:
            # destroyed here, under the lock, not wherever the traceback
            # is dropped; a pool no graph uses may not be captured into
            # again
            with contextlib.suppress(Exception):
                graph.reset()
            if not self.graphs:
                self.pool = torch.cuda.graph_pool_handle()
            raise
        finally:
            cur.wait_stream(s)  # later work on the state waits for the program
        if warm:
            _record_stream(answer, cur)
        self.graphs[key] = CapturedGraph(layout, static, graph, out, recorded, decide, scans)
        seconds = time.perf_counter() - t0
        self.capture_s += seconds
        if decide:
            self.captures += 1
        else:
            self.program_capture_s += seconds
            if first_use:
                self.first_use_captures += 1
            else:
                self.program_captures += 1
        return answer

    def inputs(self, key: tuple):
        """(layout, static input) of `key`'s graph: what a later program
        may read in place of uploading the same inputs again."""
        g = self.graphs[key]
        return g.layout, g.static

    def count(self, decide: bool) -> int:
        """Graphs held: the decides', or the other programs'."""
        return sum(1 for g in self.graphs.values() if g.decide == decide)

    def zero_counts(self) -> None:
        """The end of a warmup: zero the capture and replay counts."""
        self.captures = self.replays = 0
        self.program_captures = self.program_replays = self.first_use_captures = 0
        self.capture_s = self.program_capture_s = 0.0

    def pool_bytes(self) -> int:
        """Bytes the card holds in this set's graph pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def close(self) -> None:
        """Drop every graph and hand the pool's memory back to the card
        (no reference to a graph, or to its output, outlives the reset:
        one would keep its segment of the pool from the empty_cache)."""
        with _LOCK:
            _reset_retired()
            while self.graphs:
                self.graphs.popitem()[1].graph.reset()
        torch.cuda.empty_cache()


class EagerPrograms:
    """`DeviceGraphs.run` without graphs, for an engine on the CPU or
    with cuda_graphs=False: each call packs its inputs through the
    program's layout into a fresh buffer on `device` (or moves the fed
    tensor there) and runs the program eagerly on it. So the eager path
    runs the same programs, from the same layouts, as the graphs."""

    def __init__(self, device: torch.device):
        self.device = device
        self._staged: dict = {}

    def run(self, key: tuple, record, args=(), layout=None, feed=None, **_capture):
        if layout is None:
            static = feed.to(self.device)
        else:
            layout = layout()
            buf = np.empty(layout.nbytes, np.uint8)
            layout.pack(buf, *args)
            static = torch.from_numpy(buf).to(self.device)
        self._staged[key] = (layout, static)
        return record(static)

    def inputs(self, key: tuple):
        """(layout, static input) of `key`'s last run."""
        return self._staged[key]


def copy_to_host(out):
    """The outputs of a replay (a tensor or a tuple of them) on the card
    copied, on their device's current stream, into fresh pinned host
    tensors; waits on that copy alone (an event after it), not on later
    work. Returns the host tensors in the outputs' shape; outputs already
    on the host are returned as they are."""
    outs = out if isinstance(out, tuple) else (out,)
    if not outs[0].is_cuda:
        return out
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs)
    with torch.cuda.device(outs[0].device):
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    return host if isinstance(out, tuple) else host[0]
