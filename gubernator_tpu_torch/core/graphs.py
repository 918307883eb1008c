"""The decide as captured CUDA graphs: the port's counterpart of the JAX
package's jitted decide programs (gubernator_tpu/core/engine.py:72-101,
`_decide_packed_jit`, `_decide_packed_sketch_jit` and
`_decide_packed_chain_jit`), compiled there at warmup
(gubernator_tpu/parallel/sharded.py:2270-2284), and of its mesh's
jitted shard_map programs `_step`, `_step_sketch` and `_step_chain`
(gubernator_tpu/parallel/sharded.py:990-1043, compiled by its
`warmup_public`, :2302-2350).

Eager, one decide is ~870 torch launches whose Python dispatch keeps
the card idle most of a batch (PERF.md §5). Here each (program, request
rung B, group rung G) is captured ONCE into a `torch.cuda.CUDAGraph`
and every later batch of that shape is one replay:

- **Rows.** One graph decides `k` rows, each on its own store (and
  sketch), in row order: the flat engine is k = 1; a mesh holds one
  `DecideGraphs` a device whose k rows are the shards on that device,
  so a batch is one replay a device, as the reference's mesh is one
  shard_map program for all its shards.
- **Static inputs.** A graph reads its batch from one device byte
  buffer laid out by `DecideLayout`: the BatchRequest [k, B], the
  BatchGroups [k, G], `now` (one 0-d int32 the decide reads on the
  device) and, for chains, `chain_id` [k, B]; it writes one packed
  output [k, 4*B+4]. A batch is packed on the host into
  one pinned slot of a `StagingRing` and goes up in ONE non-blocking
  copy into that buffer, on the engine's stream, in order before the
  replay.
- **The ring.** A slot's bytes are being read by its copy until the
  copy has run on the card, so each slot records an event after its
  copy and the host waits on it before packing into the slot again. A
  slot still in flight when its turn comes makes the ring grow by one
  (up to `MAX_RING`), so the ring ends up as deep as the batches the
  caller keeps in flight.
- **State.** A capture bakes the store's and the sketch's device
  pointers into the graph, so the engine updates those tensors in place
  and never rebinds them (reset, rebase, load_state and the installs
  all write in place).
- **Capture** (`DecideGraphs._capture`, on a shape's first use): the
  batch is staged and the decide captured on the capture's side stream
  into the engine's one memory pool with
  `capture_error_mode="thread_local"` (another thread's pinned
  allocation or event wait does not abort it), then replayed once: that
  run is the batch's answer. A program's first capture on a device is
  preceded by one eager decide of the batch on that stream instead (it
  is then the answer), which loads the program's kernels and puts the
  allocator's blocks in place before anything records, as
  torch.cuda.graphs asks. Later shapes skip that run: a mesh's is k
  eager decides (~12-18 ms of host dispatch each on an H100) at each of
  up to 134 captures a warmup, and with it a mesh's captures took
  1.5-1.8x as long (PERF.md §6). A cold capture risks a first use
  inside the capture (a kernel variant only a larger size picks, a lazy
  initialisation), which raises rather than record a wrong graph;
  tests/test_torch_cuda.py's
  test_every_serving_rung_captured_cold_replays_the_eager_decide_on_card
  replays every such pair of the serving ladder against the eager
  decide. A capture that fails, or whose decide did not record exactly k
  `writeback_add` launches (one a row), raises: nothing falls back to
  the eager decide.
- **One capture at a time.** A capture is invalidated by a device-wide
  synchronize, or by the destruction of another CUDA graph, anywhere in
  the process while it runs, even with "thread_local" (measured on an
  H100: both abort it; a second engine's replays, pinned allocations,
  event waits and `empty_cache` in another thread do not). So every
  capture, every graph reset and the port's device-wide synchronizes
  (`synchronize`) hold one process-wide lock, captures run on one side
  stream a device drawn from the high-priority pool (the port's other
  side streams are default priority), the collector is off while a
  graph records, and the graphs of a `DecideGraphs` dropped without
  `close()` are not destroyed by the collector but retired and reset
  at the next safe point under the lock.
- **Replays** of all of an engine's graphs on one device share one
  memory pool (`torch.cuda.graph_pool_handle()`). That is safe because
  every replay and every read of a graph's output (the packed D2H copy
  the engine enqueues right after the replay) run in order on that
  device's current stream: the next replay of any graph may overwrite
  that output only after the copy.
- **Counting.** A replay runs no Python, so `writeback_add`'s launch
  count does not move by itself: each replay adds the launches its
  capture recorded (`writeback.count_replay`), in `DecideGraphs.replay`.

Nothing here imports CUDA state or builds anything at import; the
layout and the ring also run on the CPU (the tests hold them there).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.core import writeback
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
#: the graph dicts of DecideGraphs the collector dropped, reset under
#: _LOCK at the next capture, close or synchronize
_RETIRED: list = []


def _reset_retired() -> None:
    """Destroy the retired graphs (the caller holds _LOCK)."""
    while _RETIRED:
        for g in _RETIRED.pop().values():
            g.graph.reset()


def _retire_on_collect(owner, graphs: dict) -> None:
    """When `owner` is collected, keep its `graphs` alive in _RETIRED
    rather than let the collector destroy them, maybe inside a capture."""
    weakref.finalize(owner, _RETIRED.append, graphs)


def synchronize(device=None) -> None:
    """torch.cuda.synchronize(device), never while a decide is being
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
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


class DecideLayout:
    """Where each input of one decide lives in a graph's static byte
    buffer, for `k` rows of request rung B, group rung G and (chains) a
    chain_id column: every field [k, n] row-major at an 8-byte-aligned
    offset, int64 first, `now` once. k = 1 is the flat engine's
    layout."""

    def __init__(self, B: int, G: int, chain: bool, k: int = 1):
        self.B, self.G, self.chain, self.k = B, G, chain, k
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
        self.fields = []
        off = 0
        for part, name, dtype, n in fields:
            dtype = np.dtype(dtype)
            self.fields.append((part, name, dtype, n, off))
            rows = 1 if part == "now" else k
            off += -(-(rows * n * dtype.itemsize) // 8) * 8
        self.nbytes = off

    def pack(self, out: np.ndarray, req, groups, now, chain_id=None) -> None:
        """Write one batch (numpy BatchRequest and BatchGroups of this
        layout's shapes, [k, n] or, for k = 1, [n]; `now` an int32
        engine-ms; chain_id int32 of the request's shape for chains)
        into the uint8 array `out`."""
        parts = {"req": req, "groups": groups}
        for part, name, dtype, n, off in self.fields:
            rows = self.k
            if part == "now":
                src, rows = np.asarray([now], dtype), 1
            elif part == "chain":
                src = chain_id
            else:
                src = getattr(parts[part], name)
            shaped = src.shape == (rows, n) or (rows == 1 and src.shape == (n,))
            if not shaped or src.dtype != dtype:
                raise ValueError(f"{part}.{name}: {src.dtype}{list(src.shape)}, the layout "
                                 f"wants {dtype}[{rows}, {n}]")
            out[off:off + rows * n * dtype.itemsize].view(dtype).reshape(rows, n)[:] = src

    def views(self, buf: torch.Tensor, row: int = 0):
        """(BatchRequest, BatchGroups, now 0-d int32, chain_id or None)
        of row `row`: tensor views into the byte buffer `buf`, what a
        graph reads."""
        got = {"req": {}, "groups": {}}
        now = chain_id = None
        for part, name, dtype, n, off in self.fields:
            start = off if part == "now" else off + row * n * dtype.itemsize
            t = buf[start:start + n * dtype.itemsize].view(_TORCH_OF[dtype])
            if part == "now":
                now = t[0]
            elif part == "chain":
                chain_id = t
            else:
                got[part][name] = t
        return BatchRequest(**got["req"]), BatchGroups(**got["groups"]), now, chain_id

    def rows(self, buf: torch.Tensor) -> list:
        """Every row's views (`views`), in order."""
        return [self.views(buf, r) for r in range(self.k)]


class StagingRing:
    """Host byte slots of `nbytes` each (pinned on a GPU host) that a
    batch is packed into and copied up from, in turn. On the card each
    slot records an event after its copy and is packed again only once
    that event has passed; a slot still in flight when its turn comes
    makes the ring grow by one slot, up to MAX_RING, after which the
    host waits on it."""

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

    def upload(self, layout: DecideLayout, dst: torch.Tensor, req, groups, now,
               chain_id=None) -> None:
        """Pack one batch into the next slot and copy it into `dst` (a
        byte buffer of `layout` on the host or the card) on the current
        stream: non-blocking from a pinned slot, with the slot's event
        recorded after the copy."""
        if layout.nbytes > self.nbytes:
            raise ValueError(f"a batch of {layout.nbytes} bytes in a ring of {self.nbytes}")
        slot = self._acquire()
        host = slot[0][:layout.nbytes]
        layout.pack(host.numpy(), req, groups, now, chain_id)
        dst[:layout.nbytes].copy_(host, non_blocking=self.pin)
        if slot[1] is not None:
            slot[1].record()


class DecideGraph(NamedTuple):
    """One captured decide: its static byte buffer (the graph reads it
    through the layout's views), the graph, its static packed output
    [k, 4*B+4], and the writeback launches one replay makes (k)."""

    layout: DecideLayout
    static: torch.Tensor
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    launches: int


class DecideGraphs:
    """The captured decides of `rows` stores on one device (an engine's
    one store, or a mesh's shards on that device), one per (program, B,
    G), sharing one memory pool, captured on the device's capture
    stream; `max_batch` is the ladder's top rung (the staging slots'
    size)."""

    def __init__(self, device: torch.device, max_batch: int, rows: int = 1):
        self.device = device
        self.rows = rows
        self.pool = torch.cuda.graph_pool_handle()
        with _LOCK:
            if device not in _STREAMS:
                _STREAMS[device] = torch.cuda.Stream(device, priority=-1)
            self.stream = _STREAMS[device]
        self.ring = StagingRing(DecideLayout(max_batch, max_batch, True, rows).nbytes, pin=True)
        self.graphs: dict = {}
        _retire_on_collect(self, self.graphs)
        self.warm: set = set()  # programs decided eagerly on this device's capture stream
        self.captures = 0  # captures (each one eager decide) since the counts were zeroed
        self.capture_s = 0.0  # their host seconds
        self.replays = 0

    def run(self, program: str, stores, sketches, req, groups, now,
            chain_id=None) -> torch.Tensor:
        """Decide one batch of `rows` rows (numpy BatchRequest /
        BatchGroups [rows, n], or [n] for one row; `now` the int32
        engine-ms; chain_id numpy int32 of the request's shape for
        "chain"), row r on stores[r] and sketches[r], on the current
        stream: replay its shape's graph, or on the shape's first use
        decide it eagerly and capture the graph. Returns the packed
        output [rows, 4*B+4] on the card; the caller reads it on the
        same stream before the next run."""
        key = (program, int(req.key_hash.shape[-1]), int(groups.key_hash.shape[-1]))
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, stores, sketches, req, groups, now, chain_id)
        self.ring.upload(g.layout, g.static, req, groups, now, chain_id)
        return self.replay(g)

    def replay(self, g: DecideGraph) -> torch.Tensor:
        """Launch one captured decide on the current stream and count its
        writeback launches."""
        g.graph.replay()
        writeback.count_replay(g.launches)
        self.replays += 1
        return g.out

    def _capture(self, key, stores, sketches, req, groups, now, chain_id) -> torch.Tensor:
        with _LOCK, torch.cuda.device(self.device):
            _reset_retired()
            return self._capture_locked(key, stores, sketches, req, groups, now, chain_id)

    def _capture_locked(self, key, stores, sketches, req, groups, now,
                        chain_id) -> torch.Tensor:
        program, B, G = key
        t0 = time.perf_counter()
        layout = DecideLayout(B, G, program == "chain", self.rows)
        static = torch.empty(layout.nbytes, dtype=torch.uint8, device=self.device)
        inputs = layout.rows(static)
        cur = torch.cuda.current_stream(self.device)
        if layout.nbytes > self.ring.nbytes:
            # a rung past the ladder's top (a mesh extends its sub-batch
            # ladder on overflow): a ring of bigger slots from here on;
            # the old slots' copies keep their pinned blocks alive
            self.ring = StagingRing(layout.nbytes, pin=True)
        self.ring.upload(layout, static, req, groups, now, chain_id)
        s = self.stream
        s.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        warm = program not in self.warm
        try:
            with torch.cuda.stream(s):
                if warm:
                    # the program's warm run here, and this batch's answer
                    answer = decide_rows(program, stores, sketches, inputs)
                    self.warm.add(program)
                before = writeback.writeback_add.captured
                with _collector_off():
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        out = decide_rows(program, stores, sketches, inputs)
                    finally:
                        graph.capture_end()
                recorded = writeback.writeback_add.captured - before
                if recorded != self.rows:
                    raise RuntimeError(
                        f"decide graph {key}: its capture recorded {recorded} writeback "
                        f"launches, not {self.rows}"
                    )
                if not warm:
                    graph.replay()  # this batch's answer
                    writeback.count_replay(recorded)
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
            cur.wait_stream(s)  # later work on the store waits for the decide
        if warm:
            answer.record_stream(cur)
        self.graphs[key] = DecideGraph(layout, static, graph, out, recorded)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return answer

    def pool_bytes(self) -> int:
        """Bytes the card holds in this engine's graph pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def close(self) -> None:
        """Drop every graph and hand the pool's memory back to the card."""
        with _LOCK:
            _reset_retired()
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs.clear()
        torch.cuda.empty_cache()
