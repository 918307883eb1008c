"""One run of one cell against the port's serving core: boot it as a
deployment boots it, prefill, warm up, drive the measured window through
the batcher's array door, optionally trace a slice, then free the
program and hand what was collected to the readers and the comparison.

The recorder (`Recorder`) is how the comparison follows the port. It
wraps the backend's group prep, merge, dispatch of a merged batch and the
promoter's install call (all but the prep run on the one submit thread,
in stream order on the device) to learn which of the harness's groups
went into each device batch. At times drawn from the seed it opens a
span: on the device, in stream order and with no sync, it takes a 64-bit
digest of every store row and of every chunk of 128 sketch counters
(`devread.py`). Before each event of the span (the next batches, and any
promoter installs among them, running pipelined as every other batch
does) it gathers into buffers of its own the rows of the event's buckets
and, on a two-tier store, the counters that the event's keys and its
rows' eviction victims can read. After the span's last batch it gathers
the same rows and counters again and takes the digests again. The
reference then replays the span from the first gather of each row and
counter and is compared with every answer the span's groups got, with
the promoter's results, with the rows and counters at the close, and, by
the digests, with every row and chunk of the state that no event
touched. What it holds follows the spans' rows, not the store's size.
"""

from __future__ import annotations

import asyncio
import gc
import sys
import time
from collections import deque

import numpy as np

from portbench.check import distinct
from portbench.devread import CHUNK, Digester, lane_salts, victim_counters
from portbench.keyhash import hash_ids
from portbench.load import Load, open_schedule
from portbench.reference.limiter import Geometry, bucket_index, sketch_indices

TRACE_MARK = "portbench.traced_window"
DIGEST_BLOCK_ROWS = 1 << 16  # rows (of 128 words) the digest takes at once


def geometry(cfg: dict) -> Geometry:
    g = cfg["geometry"]
    return Geometry(g["buckets"], g["ways"], g.get("sketch_rows", 0), g.get("sketch_width", 0))


def read_rows(data, bk: np.ndarray, device) -> np.ndarray:
    """The store rows of buckets `bk`, on the host."""
    import torch

    return data.index_select(0, torch.from_numpy(bk).to(device)).cpu().numpy()


def read_counters(data, idx: np.ndarray, device) -> np.ndarray:
    """int64[rows, m] sketch counters at per-row indices `idx`, on the host."""
    import torch

    return np.stack([data[r].index_select(0, torch.from_numpy(idx[r]).to(device)).cpu().numpy()
                     for r in range(idx.shape[0])]).astype(np.int64)


def block_rows(*rows: int) -> int:
    """Rows of state read at once: at most DIGEST_BLOCK_ROWS, and a quarter
    of the smallest of `rows` (so that no temporary is the state's size)."""
    return max(1, min(DIGEST_BLOCK_ROWS, *(r // 4 for r in rows)))


def device_sync(device) -> None:
    """Wait for the device, through the port's capture lock (a device-wide
    sync must not land inside a capture)."""
    if device.type == "cuda":
        from gubernator_tpu_torch.core.graphs import synchronize

        synchronize(device)


class Span:
    """Consecutive submit-thread events between two digests of the whole
    state: `at` is what opens it ("batch": the first batch submitted after
    `due`; "promote": the first promoter install call after it), and it
    closes after `batches` batches. `bufs` holds what it gathered."""

    def __init__(self, at: str, batches: int, due: float):
        self.at, self.batches, self.due = at, int(batches), due
        self.state = "waiting"
        self.events: list = []
        self.n = 0
        self.broken = False
        self.epoch = None
        self.bufs = None  # SpanBuffers
        self.rows_used = self.ctr_used = 0
        self.union = np.zeros(0, np.int64)


class SpanBuffers:
    """One span's device buffers, made before the window: the store rows
    of each event's buckets just before it (`rows0`, in event order, their
    buckets in `bk`), and at the close the rows of every bucket the span
    touched (`union`, `rows1`) with the change of their digests, and the
    digests of `rows0` and `rows1` (`d_rows0`, `d_rows1`); on a
    two-tier store likewise the sketch counters each event can read (flat
    indices `ctr_idx`, values `ctr0` before the event and `ctr1` at the
    close) and the digest change of their chunks; and how many rows and
    chunks that no event touched changed their digest (`untouched`)."""

    def __init__(self, rows_cap: int, ctr_cap: int, width: int, ctr_dtype, device):
        import torch

        i64 = torch.int64
        self.rows_cap, self.ctr_cap = int(rows_cap), int(ctr_cap)
        self.bk = torch.empty(self.rows_cap, dtype=i64, device=device)
        self.union = torch.empty(self.rows_cap, dtype=i64, device=device)
        self.rows0 = torch.empty((self.rows_cap, width), dtype=torch.int32, device=device)
        self.rows1 = torch.empty_like(self.rows0)
        self.row_delta = torch.empty(self.rows_cap, dtype=i64, device=device)
        self.d_rows0 = torch.empty(self.rows_cap, dtype=i64, device=device)
        self.d_rows1 = torch.empty(self.rows_cap, dtype=i64, device=device)
        self.ctr_idx = torch.empty(self.ctr_cap, dtype=i64, device=device)
        self.ctr0 = torch.empty(self.ctr_cap, dtype=ctr_dtype, device=device)
        self.ctr1 = torch.empty_like(self.ctr0)
        self.chunk = torch.empty(self.ctr_cap, dtype=i64, device=device)
        self.chunk_delta = torch.empty(self.ctr_cap, dtype=i64, device=device)
        self.untouched = torch.zeros(2, dtype=i64, device=device)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in vars(self).values() if hasattr(t, "numel"))


class ReplayClock:
    """Device time of the port's captured programs while armed: a CUDA event
    on the replaying stream before and after every replay (the engine's
    `graphs.replay`: each decide, each install, the promoter's top-k),
    read once the window has closed, and the rows of the batches submitted
    meanwhile (counted by the recorder). A replay is one launch, so the
    pair spans the program's kernels and not the host's work around it."""

    def __init__(self, graphs, device):
        self.graphs = graphs
        self.device = device
        self.orig = graphs.replay
        self.armed = False
        self.pairs: list = []
        self.rows = 0
        graphs.replay = self._replay

    def _replay(self, g):
        if not self.armed:
            return self.orig(g)
        import torch

        stream = torch.cuda.current_stream(self.device)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        out = self.orig(g)
        e1.record(stream)
        self.pairs.append((e0, e1))
        return out

    def read(self) -> dict:
        """Seconds, replays and rows since armed; call after a device sync."""
        seconds = sum(e0.elapsed_time(e1) for e0, e1 in self.pairs) / 1e3
        out = dict(replay_s=seconds, replays=len(self.pairs), replay_rows=self.rows)
        self.pairs = []
        return out


class Recorder:
    """Tags groups through prep and merge, and records the spans (see the
    module docstring). Its buffers are made once, before the window, sized
    by the spans' rows, never by the store; their bytes are taken out of
    the memory peak."""

    PROMOTE_CALLS = 8  # promoter install calls a span's buffers leave room for

    def __init__(self, backend, device, spans: list, geo: Geometry, seed: int, topk: int):
        import torch

        self.backend = backend
        self.eng = backend.engine
        self.device = device
        self.geo = geo
        self.orig_prep = backend.prep_group
        self.orig_merge = backend.merge_prepped
        self.orig_submit = backend.decide_submit_merged
        self.orig_promote = getattr(backend, "promote_hashes", None)
        self.run_of = {}
        self.last = None
        self.spans: list = []
        self.cur = None
        self.answered_ids = set()
        self.cuda = device.type == "cuda"
        graphs = getattr(self.eng, "graphs", None)
        self.replay_clock = ReplayClock(graphs, device) if self.cuda and graphs is not None else None
        self.peak_before = int(torch.cuda.max_memory_allocated(device)) if self.cuda else 0
        store = self.eng.store.data
        sk = self.eng.sketch.data if geo.two_tier else None
        self.width = store.shape[1]
        self.salts = lane_salts(seed, max(self.width, CHUNK))
        block = block_rows(store.shape[0], *([sk.numel() // CHUNK] if sk is not None else []))
        self.digester = Digester(self.salts, max(self.width, CHUNK), block, device)
        self.d_store = torch.empty(store.shape[0], dtype=torch.int64, device=device)
        self.d_sketch = (torch.empty(sk.numel() // CHUNK, dtype=torch.int64, device=device)
                         if sk is not None else None)
        rung = max(self.eng.buckets)  # the most rows the engine dispatches in one batch
        self.bufs = []
        for sp in spans:
            rows = int(sp["batches"]) * rung + (self.PROMOTE_CALLS * int(topk) if sk is not None else 0)
            self.bufs.append(SpanBuffers(rows, 2 * geo.sketch_rows * rows, self.width,
                                         sk.dtype if sk is not None else torch.int64, device))
        self.buffer_bytes = (self.digester.nbytes + sum(b.nbytes for b in self.bufs)
                             + sum(t.numel() * 8 for t in (self.d_store, self.d_sketch) if t is not None))
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(device)
        backend.prep_group = self._prep
        backend.merge_prepped = self._merge
        backend.decide_submit_merged = self._submit
        if self.orig_promote is not None:
            backend.promote_hashes = self._promote

    def arm(self, spans):
        """`spans` in the configuration's order, which is the buffers'."""
        for sp, buf in zip(spans, self.bufs):
            sp.bufs = buf
        self.spans = sorted(spans, key=lambda sp: sp.due)

    def _prep(self, fields):
        run = self.orig_prep(fields)
        self.run_of[id(run)] = fields
        return run

    def _merge(self, runs):
        self.last = [self.run_of.pop(id(r), None) for r in runs]
        return self.orig_merge(runs)

    def _sketch_chunks(self):
        return self.eng.sketch.data.view(-1, CHUNK)

    def _upload(self, dst, arr: np.ndarray) -> None:
        """Host int64 `arr` into the device slice `dst`, in stream order."""
        import torch

        src = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
        dst.copy_(src.pin_memory() if self.cuda else src, non_blocking=self.cuda)

    def _opening(self, at: str):
        """The span this event opens, if one is due: digest the state."""
        if self.cur is not None:
            return self.cur
        now = time.monotonic()
        for sp in self.spans:
            if sp.state == "waiting" and sp.at == at and sp.due <= now and self.eng.clock.epoch is not None:
                sp.state, sp.epoch = "open", int(self.eng.clock.epoch)
                self.digester.into(self.d_store, self.eng.store.data)
                if self.d_sketch is not None:
                    self.digester.into(self.d_sketch, self._sketch_chunks())
                self.cur = sp
                return sp
        return None

    def _gather(self, sp, ev: dict, kh: np.ndarray, duration: np.ndarray, victims: bool) -> bool:
        """Before event `ev` of keys `kh`, in stream order: the rows of its
        buckets, and on a two-tier store the counters its keys' windows and
        (`victims`) its rows' eviction victims can read. False, with
        nothing gathered, where the span's buffers have no room left."""
        import torch

        geo, b = self.geo, sp.bufs
        e_now = ev["now"] - sp.epoch
        bk = distinct(bucket_index(kh, geo.buckets))
        nb = bk.shape[0]
        own = np.zeros(0, np.int64)
        if geo.two_tier:
            d = np.maximum(np.asarray(duration, np.int64), 1)
            idx = sketch_indices(kh, e_now // d, geo.sketch_rows, geo.sketch_width)
            own = distinct(idx + (np.arange(geo.sketch_rows) * geo.sketch_width)[:, None])
        nv = nb * geo.sketch_rows if victims and geo.two_tier else 0
        a, c = sp.rows_used, sp.ctr_used
        nc = own.shape[0] + nv
        if a + nb > b.rows_cap or c + nc > b.ctr_cap:
            return False
        self._upload(b.bk[a:a + nb], bk)
        torch.index_select(self.eng.store.data, 0, b.bk[a:a + nb], out=b.rows0[a:a + nb])
        if geo.two_tier:
            self._upload(b.ctr_idx[c:c + own.shape[0]], own)
            if nv:
                victim_counters(b.rows0[a:a + nb], e_now, geo.ways, geo.sketch_rows, geo.sketch_width,
                                b.ctr_idx[c + own.shape[0]:c + nc])
            torch.index_select(self.eng.sketch.data.view(-1), 0, b.ctr_idx[c:c + nc], out=b.ctr0[c:c + nc])
        ev["bk"] = bk
        sp.rows_used, sp.ctr_used = a + nb, c + nc
        return True

    def _close(self, sp):
        """After the span's last event, in stream order: the touched rows
        and counters again, and the digests' change."""
        import torch

        b = sp.bufs
        bks = [ev["bk"] for ev in sp.events]
        sp.union = distinct(np.concatenate(bks)) if bks else np.zeros(0, np.int64)
        nu, nc = sp.union.shape[0], sp.ctr_used
        store = self.eng.store.data
        self._upload(b.union[:nu], sp.union)
        torch.index_select(store, 0, b.union[:nu], out=b.rows1[:nu])
        self.digester.subtract(self.d_store, store)
        torch.index_select(self.d_store, 0, b.union[:nu], out=b.row_delta[:nu])
        self.d_store.index_fill_(0, b.union[:nu], 0)
        torch.sum(self.d_store.ne_(0), dim=0, out=b.untouched[0])
        self.digester.into(b.d_rows0[:sp.rows_used], b.rows0[:sp.rows_used])
        self.digester.into(b.d_rows1[:nu], b.rows1[:nu])
        if self.d_sketch is not None:
            torch.index_select(self.eng.sketch.data.view(-1), 0, b.ctr_idx[:nc], out=b.ctr1[:nc])
            self.digester.subtract(self.d_sketch, self._sketch_chunks())
            torch.div(b.ctr_idx[:nc], CHUNK, rounding_mode="floor", out=b.chunk[:nc])
            torch.index_select(self.d_sketch, 0, b.chunk[:nc], out=b.chunk_delta[:nc])
            self.d_sketch.index_fill_(0, b.chunk[:nc], 0)
            torch.sum(self.d_sketch.ne_(0), dim=0, out=b.untouched[1])
        sp.state = "done"
        self.cur = None

    def _submit(self, merged, now=None):
        from gubernator_tpu_torch.api import types as api_types

        groups, self.last = self.last, None
        if self.replay_clock is not None and self.replay_clock.armed:
            self.replay_clock.rows += int(merged["n"])
        sp = self._opening("batch")
        if sp is None:
            return self.orig_submit(merged, now)
        if now is None:
            now = api_types.millisecond_now()
        if not groups or any(g is None for g in groups):
            sp.broken = True
        n = int(merged["n"])
        req = merged["req"]
        kh = np.asarray(req.key_hash[:n]).view(np.uint64)
        ev = dict(kind="batch", groups=groups or [], now=int(now), merged_n=n, merged_kh=np.sort(kh))
        if sp.broken:
            duration = np.asarray(req.duration[:n])
        else:
            kh = np.concatenate([g["key_hash"] for g in groups]).astype(np.uint64)
            duration = np.concatenate([g["duration"] for g in groups])
        if not self._gather(sp, ev, kh, duration, victims=True):
            self._close(sp)
            return self.orig_submit(merged, now)
        sp.events.append(ev)
        self.answered_ids.update(id(g) for g in groups or [] if g is not None)
        handle = self.orig_submit(merged, now)
        sp.n += 1
        if sp.n >= sp.batches:
            self._close(sp)
        return handle

    def _promote(self, key_hash, limits, durations, now=None):
        from gubernator_tpu_torch.api import types as api_types

        sp = self._opening("promote")
        if sp is None:
            return self.orig_promote(key_hash, limits, durations, now)
        if now is None:
            now = api_types.millisecond_now()
        ev = dict(kind="promote", key_hash=np.array(key_hash, np.uint64), limit=np.array(limits, np.int64),
                  duration=np.array(durations, np.int64), now=int(now))
        if not self._gather(sp, ev, ev["key_hash"], ev["duration"], victims=False):
            self._close(sp)
            return self.orig_promote(key_hash, limits, durations, now)
        res = self.orig_promote(key_hash, limits, durations, now)
        ev["result"] = [np.array(x).astype(np.int64) for x in res]
        sp.events.append(ev)
        return res

    def finish(self):
        """Close a span the window's end left open (on the submit thread,
        after the batcher drained) and stop opening new ones."""
        if self.cur is not None:
            self._close(self.cur)
        for sp in self.spans:
            if sp.state == "waiting":
                sp.state = "never"

    def host_spans(self) -> list:
        """The finished spans with what they gathered on the host (the used
        part of each buffer), the device buffers freed."""
        out = []
        for sp in self.spans:
            if sp.state != "done":
                out.append(dict(at=sp.at, opened=False, events=[]))
                continue
            b = sp.bufs
            na, nu, nc = sp.rows_used, sp.union.shape[0], sp.ctr_used
            host = lambda t: t.cpu().numpy()  # noqa: E731
            out.append(dict(
                at=sp.at, opened=True, broken=sp.broken, epoch=sp.epoch, events=sp.events,
                salts=self.salts, union=sp.union, rows0=host(b.rows0[:na]), rows1=host(b.rows1[:nu]),
                row_delta=host(b.row_delta[:nu]), d_rows0=host(b.d_rows0[:na]), d_rows1=host(b.d_rows1[:nu]),
                untouched=host(b.untouched),
                ctr_idx=host(b.ctr_idx[:nc]), ctr0=host(b.ctr0[:nc]), ctr1=host(b.ctr1[:nc]),
                chunk_delta=host(b.chunk_delta[:nc]),
            ))
            sp.bufs = None
        self.bufs = []
        self.d_store = self.d_sketch = self.digester = None
        return out


def process_cpu_per_s(t0: float, cpu0: float) -> float:
    """This process's CPU seconds a second since (t0, cpu0)."""
    return (time.process_time() - cpu0) / max(time.monotonic() - t0, 1e-9)


class GcClock:
    """Seconds spent in the interpreter's generation-2 collections while on."""

    def __init__(self):
        self.seconds = 0.0
        self.count = 0
        self._t0 = None

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            self.seconds += time.monotonic() - self._t0
            self.count += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


class Collector:
    """What the callers saw: answered rows (in all, in the window, and a
    second at a time), range violations, failures, per-request times,
    and the answers of the groups in the recorder's spans."""

    def __init__(self, rec: Recorder, limit: int):
        self.rec = rec
        self.limit = limit
        self.answers = {}
        self.reset()

    def reset(self, t0: float = 0.0):
        self.sent = self.failed = self.rows_in_window = self.rows_answered = 0
        self.out_of_range = 0
        self.latency_s, self.lag_s = [], []
        self.t0 = t0
        self.per_second: dict = {}

    def answered(self, fields, out, in_window: bool):
        status, limit, remaining, reset = out
        n = status.shape[0]
        self.rows_answered += n
        if in_window:
            self.rows_in_window += n
            sec = int(time.monotonic() - self.t0)
            self.per_second[sec] = self.per_second.get(sec, 0) + n
        self.out_of_range += int(np.count_nonzero(
            ((status != 0) & (status != 1)) | (limit != self.limit) | (remaining < 0)
            | (remaining > self.limit) | (reset < 0)))
        if id(fields) in self.rec.answered_ids:
            self.answers[id(fields)] = np.stack([np.asarray(a, np.int64) for a in out])


async def closed_loop(batcher, load: Load, col: Collector, seconds: float, callers: int, k0: list):
    """`callers` callers, each sending its next group when the last is
    answered, until `seconds` have passed; rows answered by then count."""
    stop = time.monotonic() + seconds

    async def caller():
        while time.monotonic() < stop:
            fields = load.group(k0[0])
            k0[0] += 1
            col.sent += 1
            try:
                out = await batcher.decide_arrays(fields)
            except Exception:
                col.failed += 1
                continue
            col.answered(fields, out, time.monotonic() <= stop)

    t0 = time.monotonic()
    await asyncio.gather(*[caller() for _ in range(callers)])
    return t0, stop


async def open_loop(batcher, load: Load, col: Collector, due: np.ndarray, seconds: float, k0: list):
    """Send request i at its due time whatever the answers before it; each
    request's time runs from its due time to its answer. The schedule runs
    on the port's event loop, where a server's arriving requests wait for
    it too, so a late loop shows in the generator's lag and in the times
    alike (a sending thread of its own was tried: waiting for the GIL made
    its lag p99 54-236 ms, PERF.md)."""
    t0 = time.monotonic()
    tasks = set()

    async def one(fields, t_due):
        try:
            out = await batcher.decide_arrays(fields)
        except Exception:
            col.failed += 1
            col.latency_s.append(float("inf"))
            return
        col.latency_s.append(time.monotonic() - t_due)
        col.answered(fields, out, True)

    for off in due:
        t_due = t0 + float(off)
        wait = t_due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        fields = load.group(k0[0])
        k0[0] += 1
        col.sent += 1
        col.lag_s.append(time.monotonic() - t_due)
        task = asyncio.ensure_future(one(fields, t_due))
        tasks.add(task)
        task.add_done_callback(tasks.discard)
    await asyncio.gather(*tasks)
    return t0, t0 + seconds


def batch_histogram():
    """(rows, batches) in the batcher's device_batch_size histogram."""
    from gubernator_tpu_torch.serve import metrics

    s = {x.name: x.value for x in metrics.DEVICE_BATCH_SIZE.collect()[0].samples}
    return s["device_batch_size_sum"], s["device_batch_size_count"]


def prefill(eng, cfg: dict) -> dict:
    """The configuration's prefill through the engine: `ids` sequential
    fresh token keys in batches of `batch_rows`, two batches in flight.
    Returns what the comparison needs to replay it."""
    from gubernator_tpu_torch.api import types as api_types

    p = cfg.get("prefill")
    a = cfg["assumed"]
    rec = dict(ids=0)
    if p:
        n = int(p["ids"])
        rows = int(p["batch_rows"])
        ones = np.ones(rows, np.int64)
        handles, nows = deque(), []
        for s in range(0, n, rows):
            m = min(rows, n - s)
            now = api_types.millisecond_now()
            nows.append(now)
            handles.append(eng.decide_submit(
                hash_ids(np.arange(s, s + m)), ones[:m], ones[:m] * a["limit"],
                ones[:m] * a["duration_ms"], np.zeros(m, np.int32), np.zeros(m, bool), now))
            while len(handles) > 2 or (handles and s + m >= n):
                status = eng.decide_wait(handles.popleft())[0]
                rec["refused"] = rec.get("refused", 0) + int(np.count_nonzero(status))
        rec.update(ids=n, batch_rows=rows, nows=nows)
    rec["epoch"] = eng.clock.epoch
    return rec


def sample_sorted(rng, n: int, k: int) -> np.ndarray:
    """k distinct sorted integers drawn uniformly from 0 .. n-1, with no
    array of n elements."""
    if k >= n:
        return np.arange(n, dtype=np.int64)
    got = np.zeros(0, np.int64)
    while got.shape[0] < k:
        got = distinct(np.concatenate([got, rng.integers(0, n, 2 * (k - got.shape[0]) + 16)]))
    return np.sort(rng.choice(got, k, replace=False))


def read_start(eng, cfg: dict, geo: Geometry, seed: int, device, rec: dict) -> dict:
    """Into the prefill's record, the start state the comparison checks:
    sampled bucket rows and sketch counters, and the store's nonzero
    words (a cell with no prefill starts from an empty store)."""
    import torch

    rng = np.random.default_rng(seed ^ 0x5EED)
    bk = sample_sorted(rng, geo.buckets, int(cfg["check"]["start_buckets"]))
    device_sync(device)
    rec["buckets"] = bk
    rec["rows"] = read_rows(eng.store.data, bk, device)
    nonzero = torch.zeros((), dtype=torch.int64, device=device)
    block = block_rows(geo.buckets)
    for i in range(0, geo.buckets, block):
        nonzero += torch.count_nonzero(eng.store.data[i:i + block])
    rec["store_nonzero"] = int(nonzero.item())
    if geo.two_tier:
        nc = int(cfg["check"]["start_counters"])
        idx = np.stack([sample_sorted(rng, geo.sketch_width, nc) for _ in range(geo.sketch_rows)])
        rec["counter_idx"] = idx
        rec["counters"] = read_counters(eng.sketch.data, idx, device)
    return rec


def check_of(cfg: dict, traffic: dict) -> dict:
    """The configuration's check, which the traffic may narrow."""
    return dict(cfg["check"], **traffic.get("check", {}))


async def boot(cfg: dict, check: dict, seed: int, device, patch=None) -> dict:
    """The serving core booted as a deployment boots it (config_from_env ->
    make_backend -> warmup -> Instance -> start -> set_peers with this node
    alone on the ring), with the configuration's prefill run through the
    engine before the instance starts, and the recorder in place."""
    import torch

    from gubernator_tpu_torch.api.types import PeerInfo
    from gubernator_tpu_torch.serve.backends import make_backend
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.instance import Instance

    device = torch.device(device)
    geo = geometry(cfg)
    if patch is not None:
        patch.before_boot()
    conf = config_from_env(dict(cfg["env"]))
    backend = make_backend(conf, device=device)
    eng = backend.engine
    shape = list(eng.store.data.shape)
    sk_shape = list(eng.sketch.data.shape) if eng.sketch is not None else [0, 0]
    want = [geo.buckets, geo.ways * 8], [geo.sketch_rows, geo.sketch_width]
    if (shape, sk_shape) != tuple(want):
        raise RuntimeError(f"the program built store {shape} and sketch {sk_shape}; "
                           f"the configuration states {want[0]} and {want[1]}")
    t0 = time.monotonic()
    await asyncio.to_thread(backend.warmup)
    warmup_s = time.monotonic() - t0
    t0 = time.monotonic()
    start = read_start(eng, cfg, geo, seed, device, prefill(eng, cfg))
    prefill_s = time.monotonic() - t0
    rec = Recorder(backend, device, check["spans"], geo, seed, conf.sketch_topk)
    if patch is not None:
        patch.on_backend(backend)
    inst = Instance(conf, backend)
    inst.start()
    await inst.set_peers([PeerInfo(address=cfg["env"]["GUBER_GRPC_ADDRESS"], is_owner=True)])
    return dict(device=device, geo=geo, backend=backend, eng=eng, inst=inst, rec=rec,
                start=start, warmup_s=warmup_s, prefill_s=prefill_s)


async def run_cell(cfg: dict, traffic: dict, stream_mod, seed: int, seconds: float, trace: bool,
                   device, t_start: float, patch=None) -> dict:
    """One run; returns everything the readers and the comparison take.
    `patch` (controls and fault tests only) has `before_boot()` and
    `on_backend(backend)`, called before the program is built and once
    its backend is."""
    import torch

    from gubernator_tpu_torch.serve.stages import STAGES

    check = check_of(cfg, traffic)
    a = cfg["assumed"]
    load = Load(traffic, cfg, stream_mod, seed, start_id=int((cfg.get("prefill") or {}).get("ids", 0)))
    try:
        ctx = await boot(cfg, check, seed, device, patch)
        device, geo, backend, eng = ctx["device"], ctx["geo"], ctx["backend"], ctx["eng"]
        inst, rec, start = ctx["inst"], ctx["rec"], ctx["start"]
        warmup_s, prefill_s = ctx["warmup_s"], ctx["prefill_s"]
        batcher = inst.batcher
        col = Collector(rec, int(a["limit"]))
        k0 = [0]
        is_open = traffic["loop"] == "open"
        callers = int(traffic.get("callers", 16))

        async def drive(length: float, sched_seed: int):
            if is_open:
                due = open_schedule(float(traffic["rate_rps"]), length, int(traffic["gap_seed"]),
                                    sched_seed)
                return await open_loop(batcher, load, col, due, length, k0)
            return await closed_loop(batcher, load, col, length, callers, k0)

        await drive(float(traffic["warmup_s"]), seed + 1)
        await batcher.drain()

        # the measured window: spans opened at times drawn from the seed
        rng = np.random.default_rng(seed % (1 << 64) ^ 0xC4EC)
        frac = rng.uniform(0.05, 0.8, len(check["spans"]))
        stats0, hist0 = backend.stats(), batch_histogram()
        promo0 = inst.promoter.stats() if inst.promoter is not None else None
        wait0 = load.wait_s
        STAGES.reset()
        setup_s = time.monotonic() - t_start
        w_start, w_unix = time.monotonic(), time.time()
        rec.arm([Span(sp.get("at", "batch"), sp["batches"], w_start + f * seconds)
                 for sp, f in zip(check["spans"], frac)])
        col.reset(w_start)
        cpu0 = time.process_time()
        if rec.replay_clock is not None:
            rec.replay_clock.armed = True
        with GcClock() as gcc:
            w0, w1 = await drive(seconds, seed)
        if rec.replay_clock is not None:
            rec.replay_clock.armed = False
        cpu_per_s = process_cpu_per_s(w_start, cpu0)
        stages = STAGES.snapshot()["stages"]
        hist1, stats1 = batch_histogram(), backend.stats()
        window = dict(
            seconds=seconds, start=w0, end=w1, sent=col.sent, failed=col.failed,
            rows_in_window=col.rows_in_window, rows_answered=col.rows_answered,
            out_of_range=col.out_of_range, latency_s=list(col.latency_s), lag_s=list(col.lag_s),
            stages=stages, stats={k: stats1[k] - stats0[k] for k in stats1},
            device_rows=hist1[0] - hist0[0], device_batches=hist1[1] - hist0[1],
            promoter=({k: v - promo0.get(k, 0) for k, v in inst.promoter.stats().items()}
                      if promo0 is not None else None),
            per_second=[col.per_second.get(i, 0) for i in range(int(np.ceil(seconds)))], start_unix=w_unix,
            process_cpu_per_s=cpu_per_s, gc2_s=gcc.seconds, gc2_count=gcc.count,
            generator_wait_s=load.wait_s - wait0,
        )
        await batcher.drain()
        await batcher.run_serialized(rec.finish)
        if rec.replay_clock is not None:
            device_sync(device)
            window.update(rec.replay_clock.read())
        checked_totals = dict(sent=col.sent, failed=col.failed, out_of_range=col.out_of_range)

        profile = None
        if trace:
            profile = await traced_slice(batcher, drive, float(traffic.get("trace_s", 1.0)), seed, device,
                                         col, backend)
            checked_totals["out_of_range"] += col.out_of_range
            checked_totals["failed"] += col.failed
        await batcher.drain()
        mem = 0
        if device.type == "cuda":
            mem = max(rec.peak_before, int(torch.cuda.max_memory_allocated(device)) - rec.buffer_bytes)
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        graph_captures = getattr(eng, "graph_captures", 0)
        await inst.stop()
        device_sync(device)
        spans = rec.host_spans()
        answers = col.answers
        del inst, batcher, rec, backend, eng, col, ctx
    finally:
        load.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(
        config=cfg, traffic=traffic, check=check, seed=seed, geo=geo, setup_s=setup_s,
        warmup_s=warmup_s, prefill_s=prefill_s, window=window, profile=profile, start=start,
        spans=spans, answers=answers, totals=checked_totals, memory_peak_bytes=mem, kind=kind,
        graph_captures=graph_captures,
    )


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the traced slice's ends on the device


async def traced_slice(batcher, drive, length: float, seed: int, device, col: Collector, backend,
                       attempts: int = 3):
    """A slice of the same load under torch.profiler, tracing the device
    only (host-side op recording slows the host that paces this system).
    The slice's ends are two marker kernels issued on an idle device, so
    device busy time is the union of the device's intervals between them.
    A profile that holds no device interval between the markers (seen in
    one traced run of nine on the card) is taken again, up to `attempts`
    slices in all."""
    for k in range(attempts):
        red = await _one_traced_slice(batcher, drive, length, seed + 2 + k, device, col, backend)
        if red["busy_ns"] > 0 or device.type != "cuda":
            red["attempts"] = k + 1
            return red
        print(f"portbench: traced slice {k + 1} held no device activity between its markers "
              f"({red['recorded']} device intervals recorded in all)", file=sys.stderr)
    raise RuntimeError(f"torch.profiler recorded no device activity in {attempts} traced slices")


async def _one_traced_slice(batcher, drive, length: float, seed: int, device, col: Collector, backend):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    await batcher.drain()
    device_sync(device)
    col.reset()
    b0, r0 = backend.stats()["batches"], col.rows_answered
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with record_function(TRACE_MARK):
            if cuda:
                torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            await drive(length, seed)
            await batcher.drain()
            if cuda:
                torch.cuda._sleep(1000)
            device_sync(device)
            wall = time.perf_counter() - t0
    dev, host, span = trace.events_of(prof, TRACE_MARK)
    marks = sorted(e for e in dev if MARKER in e[2])
    recorded = len(dev)
    dev = [e for e in dev if MARKER not in e[2] and e[2] != TRACE_MARK]
    if len(marks) >= 2:
        lo, hi = marks[0][0], marks[-1][1]
    elif span:
        lo, hi = span
    else:
        lo, hi = 0, int(wall * 1e9)
    red = trace.reduce(dev, host, lo, hi)
    red.update(wall_s=wall, batches=backend.stats()["batches"] - b0,
               rows=col.rows_answered - r0, recorded=recorded)
    return red
