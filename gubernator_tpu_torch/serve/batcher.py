"""Device micro-batcher: coalesces concurrent requests into device batches.

The port's copy of gubernator_tpu/serve/batcher.py with its imports
rewritten. Left out, to come with the backends that use them: the inline
fast path and the blocking decide of host backends (ExactBackend), and
the quota-chain lane. The knobs come from the caller (serve/config.py
ServerConfig), never from the environment; the native prep library
sizes its own thread pool from GUBER_PREP_THREADS, as the reference's
does. The file references below are the reference package's.

The reference fans each request out to a goroutine and serializes them on a
cache mutex (reference gubernator.go:90-160, 237). Here the inversion that
makes the TPU fast: requests from all in-flight RPCs are coalesced into one
dense batch (up to `batch_limit`, waiting at most `batch_wait` after the
first arrival) and decided in a single kernel launch. One flusher task owns
the backend, so no locks exist anywhere on the hot path.

The backend call itself runs in a worker thread (it blocks on the device);
the event loop keeps accepting requests for the *next* batch meanwhile,
giving natural double-buffering: batch N on device while batch N+1 fills.

The backend's decide_submit/decide_wait give one more level of
pipelining: the flusher submits batch N+1 (host presort +
async dispatch) while batch N's device fetch is still in flight, so
sustained throughput tracks max(host work, device time) per batch instead
of their sum. Up to `fetch_depth` batches may be in flight (default 2):
submits stay strictly serialized on one thread, but fetches run on a
fetch_depth-wide pool and may complete out of order — each batch's
futures resolve independently, and the engines' stats land through a
lock (core/engine.py EngineStats). On a CUDA device each fetch waits on
its own batch's copy event (parallel/sharded.py TorchEngine._handle),
so a fetch never waits for batches submitted after it.

Deep-batch mode (GUBER_DEVICE_DEEP_BATCH, serve/config.py) additionally
accumulates toward batch_limit while every pipeline slot is occupied — a
flush could not submit anyway — building the deep batches that amortize
per-batch fixed device costs (the big-store full-table writeback pass).
Idle flush semantics are unchanged: the hold predicate is False whenever
a slot is free.

Arrival-time prep (r9, GUBER_PREP_AT_ARRIVAL): on array-capable device
backends, each caller group's host prep — request->array conversion +
batch hashing (object groups), device-dtype clipping, and the
ownership/bucket PRE-SORT — is kicked onto a small prep pool the moment
the group is enqueued, overlapping the queue wait it was going to pay
anyway (batch_queue measured 16.7ms mean at the r7 profile while
submit_host burned 32.8ms serialized). By flush time the batch is a set
of sorted runs; the submit thread k-way MERGES them (serve/prep.py,
O(n log k)) and dispatches — the only serialized work left. The
submit-thread interior is stage-attributed as prep/merge/dispatch
(serve/stages.py); flush-time prep remains as the fallback for
un-prepped groups and as the whole path when the knob is off
(the BENCH_SUBMIT_r9.json A/B baseline).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.api.types import RateLimitReq, RateLimitResp
from gubernator_tpu_torch.native import load_hashlib
from gubernator_tpu_torch.serve import metrics, tracing
from gubernator_tpu_torch.serve.aio import collect_batch
from gubernator_tpu_torch.serve.faults import FAULTS, FaultError
from gubernator_tpu_torch.serve.stages import STAGES


class _QMeta:
    """Per-queue-entry mark, riding slot -2 of every queue tuple (was a
    bare enqueue stamp pre-r16): the enqueue time (always stamped now —
    the batcher_queue_oldest_age_seconds gauge needs it for every
    entry), the frame flag (per-frame stage attribution keeps its r7
    contract: only frame-flagged groups enter coverage), and the
    caller's active trace, captured at enqueue so the flusher — which
    runs outside the caller's context — can attribute batch_queue and
    device spans to it (serve/tracing.py)."""

    __slots__ = ("t", "frame", "trace")

    def __init__(self, frame: bool):
        self.t = time.monotonic()
        self.frame = frame
        self.trace = tracing.active()


def _prep_result(prep: "concurrent.futures.Future"):
    """Resolve an arrival-prep future on the submit thread. A pool
    shutdown (stop() racing a flush) surfaces as CancelledError, which
    is a BaseException the pipelined submit's failure guard would not
    convert to per-item errors — normalize it here."""
    try:
        return prep.result()
    except concurrent.futures.CancelledError:
        raise RuntimeError("prep cancelled (batcher stopping)") from None


def _item_weight(item) -> int:
    """Queue items are whole groups; the batch limit counts underlying
    requests/updates, not queue entries."""
    if item[0] == "decide_arrays":
        return max(1, item[1]["key_hash"].shape[0])
    return max(1, len(item[1]))


class DeviceBatcher:
    def __init__(
        self,
        backend,
        batch_wait: float = 0.0005,
        batch_limit: int = 1000,
        fetch_depth: int = 2,
        deep_batch: bool = False,
        prep_at_arrival: bool = True,
        prep_threads: int = 0,
    ):
        self.backend = backend
        self.batch_wait = batch_wait
        self.batch_limit = batch_limit
        # throughput mode (GUBER_DEVICE_DEEP_BATCH): while the submit
        # gate is saturated (every fetch_depth slot occupied — a flush
        # could not submit anyway), keep accumulating toward
        # batch_limit instead of parking a shallow batch at the
        # semaphore. Deep batches amortize per-batch fixed device costs
        # (the big-store full-table writeback); idle/light-load flush
        # semantics are byte-identical to deep_batch=False because the
        # hold predicate is False whenever a pipeline slot is free.
        self.deep_batch = bool(deep_batch)
        self.fetch_depth = max(1, int(fetch_depth))
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        # in-flight fetches of submitted batches (pipelined backends
        # only); each task resolves its own batch's futures. The
        # semaphore admits a submit only while fewer than fetch_depth
        # batches are outstanding.
        self._pending: set = set()
        self._inflight = asyncio.Semaphore(self.fetch_depth)
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.fetch_depth, thread_name_prefix="guber-fetch"
        )
        if self.fetch_depth > 1:
            # size the native prep's buffer ring to the pipeline depth
            # BEFORE any prep call (hashlib_native.set_prep_generations)
            hn = load_hashlib()
            if hn is not None:
                hn.set_prep_generations(self.fetch_depth + 1)
        # ONE dedicated submit thread (not the shared to_thread pool):
        # every store mutation is serialized on it, in submit order, and
        # the native prep's per-thread buffers stay on one thread
        self._submit_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="guber-submit"
        )
        # last backend stats snapshot, for cache_access_count /
        # store_dropped_creates / store_evictions deltas
        self._last_hits = 0
        self._last_misses = 0
        self._last_dropped = 0
        self._last_evictions = 0
        # set before the flusher is cancelled: a decide()/update_globals()
        # after stop() would otherwise enqueue into a queue no flusher
        # reads and await a future that never resolves (same guard as
        # PeerClient._closed)
        self._closed = False
        self.prep_at_arrival = bool(prep_at_arrival)
        if prep_threads <= 0:
            # auto: leave a core for the serving loop — a prep pool as
            # wide as the box measurably thrashes small hosts (2-core
            # A/B: pool=2 cost 6% decisions/s vs pool=1 at parity; a
            # group's prep budget is its whole batch_queue wait, so
            # narrow pools keep up easily)
            prep_threads = max(1, min(4, (os.cpu_count() or 2) - 1))
        self.prep_threads = prep_threads
        # workers spawn on first submit, so an idle prep path costs no
        # threads
        self._prep_pool = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=self.prep_threads,
                thread_name_prefix="guber-prep",
            )
            if self.prep_at_arrival
            else None
        )
        self._flushing = False
        self._live_batch: List = []
        # one-slot park for a group that would have pushed the previous
        # batch past batch_limit (aio.collect_batch carry contract)
        self._carry: List = []

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in list(self._pending):
            await t  # drain every in-flight fetch gracefully
        self._pending.clear()
        self._submit_pool.shutdown(wait=False)
        self._fetch_pool.shutdown(wait=False)
        if self._prep_pool is not None:
            # cancel queued-but-unstarted arrival preps; running ones
            # finish on their own (their results are simply dropped —
            # every caller future was already failed above, so no
            # future is stranded waiting on a prep)
            self._prep_pool.shutdown(wait=False, cancel_futures=True)

    async def drain(self) -> None:
        """Graceful-drain wait: resolves when no queued, collected,
        parked, or in-flight work remains. Callers must have stopped
        feeding the batcher first (drain doesn't gate decide()); the
        server's drain path bounds this with the GUBER_DRAIN_TIMEOUT_MS
        budget."""
        while (
            not self._queue.empty()
            or self._live_batch
            or self._carry
            or self._flushing
            or self._pending
        ):
            await asyncio.sleep(0.005)

    async def decide(
        self,
        reqs: Sequence[RateLimitReq],
        gnp: Sequence[bool],
        frame: bool = False,
    ) -> List[RateLimitResp]:
        """Submit requests; resolves when their device batch completes.
        `frame=True` marks the group as one edge frame's work for the
        per-frame stage clock (serve/stages.py)."""
        if not reqs:
            return []
        if self._closed:
            raise RuntimeError("DeviceBatcher is stopped")
        # one queue item + ONE future per caller (an RPC's whole request
        # list): per-item futures cost ~0.1-0.3ms of event-loop work per
        # request on a contended host, which at 1000-item batches was
        # 100-300ms of pure asyncio overhead per RPC — 10x the device
        # time. Groups are flattened at flush and responses sliced back.
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        reqs_l = list(reqs)
        gnp_l = [bool(g) for g in gnp]
        # the second-to-last slot of EVERY queue tuple is a _QMeta
        # mark: enqueue stamp (queue-age gauge), frame flag (per-frame
        # stages must count ONLY groups that belong to an edge frame,
        # or the coverage ratio's numerator outgrows its denominator
        # under direct gRPC/HTTP/peer traffic), and the caller's trace
        self._queue.put_nowait(
            ("decide", reqs_l, gnp_l,
             self._kick_prep("prep_reqs", reqs_l, gnp_l),
             _QMeta(frame), fut)
        )
        return await fut

    def _kick_prep(self, method: str, *args):
        """Arrival-time prep kick: schedule this group's conversion +
        presort on the prep pool NOW, so it overlaps the group's own
        queue wait. Returns the prep future to ride in the queue tuple,
        or None when arrival prep is off (the flush-time path preps the
        batch on the submit thread instead)."""
        if not self.prep_at_arrival:
            return None
        try:
            return self._prep_pool.submit(
                getattr(self.backend, method), *args
            )
        except RuntimeError:  # pool shut down: stop() raced the caller
            return None

    async def decide_arrays(self, fields: dict, frame: bool = True):
        """Array-group decide — the edge bridge's pre-hashed fast path.
        `fields`: key_hash/hits/limit/duration/algo numpy arrays (gnp
        optional, default all-False; the edge routes GLOBAL items via the
        request-object path). Resolves to (status, limit, remaining,
        reset_time) arrays for exactly these rows, co-batched and
        pipelined with every other caller. Only valid on backends
        exposing decide_submit_arrays (the device backends).
        `frame=False` keeps a group out of the per-frame stage clock —
        a chunked frame flags only its first chunk, so one frame
        contributes one batch_queue/device span, not one per chunk.

        Empty-group contract (pinned by tests/test_prep_pipeline.py):
        a zero-row `key_hash` resolves immediately to four EMPTY
        int64 arrays — the canonical wire dtype, regardless of the
        narrower dtypes a real device batch returns."""
        if fields["key_hash"].shape[0] == 0:
            z = np.empty(0, np.int64)
            return z, z, z, z
        if self._closed:
            raise RuntimeError("DeviceBatcher is stopped")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._queue.put_nowait(
            ("decide_arrays", fields,
             self._kick_prep("prep_group", fields),
             _QMeta(frame), fut)
        )
        return await fut

    async def run_serialized(self, fn, *args):
        """Run `fn(*args)` on the single submit thread, serialized with
        every device dispatch. Bucket replication's snapshot reads
        (serve/replication.py) use this: the store gather is
        non-mutating but must not overlap a decide that DONATES the
        store buffer, and the one-wide submit pool is exactly that
        ordering guarantee."""
        if self._closed:
            raise RuntimeError("DeviceBatcher is stopped")
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._submit_pool, fn, *args)

    async def update_globals(self, updates) -> None:
        """Replica installs funnel through the same flusher queue so the
        backend stays single-threaded."""
        if self._closed:
            raise RuntimeError("DeviceBatcher is stopped")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._queue.put_nowait(("globals", updates, _QMeta(False), fut))
        await fut

    # -- queue visibility (r16) ---------------------------------------------

    def queue_stats(self) -> dict:
        """Standing-work snapshot for the lazily-set scrape gauges
        (serve/metrics.py batcher_queue_*): depth counts caller groups
        queued + collected-but-unflushed + parked carry; oldest age
        reads the _QMeta enqueue stamps. Runs on the serving loop (the
        /metrics handler), so the peek at the queue's internal deque
        cannot race an enqueue."""
        items = (
            list(getattr(self._queue, "_queue", ()))
            + self._live_batch
            + self._carry
        )
        oldest = min((it[-2].t for it in items), default=None)
        prep_backlog = 0
        if self._prep_pool is not None:
            q = getattr(self._prep_pool, "_work_queue", None)
            if q is not None:
                prep_backlog = q.qsize()
        return {
            "depth": len(items),
            "oldest_age_s": (
                time.monotonic() - oldest if oldest is not None else 0.0
            ),
            "prep_backlog": prep_backlog,
        }

    def _rung(self, n: int) -> int:
        """The padding-ladder rung a batch of n rows launches at — the
        device-span annotation (r16). Engines keep a sorted `buckets`
        ladder; a backend without one reports the batch size itself."""
        buckets = getattr(
            getattr(self.backend, "engine", None), "buckets", None
        )
        if buckets:
            for b in buckets:
                if b >= n:
                    return int(b)
        return int(n)

    def _trace_device(
        self, items, t_collect: float, total: int, extra=None
    ) -> None:
        """Attach the device span (+ batch annotations) to every traced
        caller group of a flushed batch. Annotations are computed only
        when at least one group carries a trace — the untraced path
        pays one attribute check per group (r16)."""
        traced = [it for it in items if it[-2].trace is not None]
        if not traced:
            return
        algos: dict = {}
        for it in items:
            if it[0] == "decide_arrays":
                vals, counts = np.unique(
                    np.asarray(it[1]["algo"]), return_counts=True
                )
                for v, c in zip(vals.tolist(), counts.tolist()):
                    algos[int(v)] = algos.get(int(v), 0) + int(c)
            else:
                for r in it[1]:
                    a = int(r.algorithm)
                    algos[a] = algos.get(a, 0) + 1
        ann = dict(
            batch=int(total),
            rung=self._rung(int(total)),
            algo_mix={str(k): v for k, v in sorted(algos.items())},
        )
        if extra:
            ann.update(extra)
        now = time.monotonic()
        for it in traced:
            it[-2].trace.add_span(
                "device", start=t_collect, end=now, **ann
            )

    async def _run(self) -> None:
        while True:
            batch: List[Tuple] = []
            # collected-but-unflushed groups, visible to queue_stats and
            # drain
            self._live_batch = batch
            try:
                # Everything already enqueued rides this launch; while
                # the backend is busy in _flush, new arrivals accumulate
                # in the queue, so batches grow with load on their own
                # ("batch while busy") and a solo request only waits the
                # optional batch_wait window. The collect runs INSIDE
                # the try (and is cancellation-race-safe, serve/aio.py):
                # a cancel must reach the drain handler below with every
                # collected item visible, or a caller would hang.
                await collect_batch(
                    self._queue, self.batch_limit, self.batch_wait, batch,
                    weight=_item_weight, carry=self._carry,
                    hold_while=(
                        self._inflight.locked if self.deep_batch else None
                    ),
                )
                self._flushing = True
                try:
                    await self._flush(batch)
                finally:
                    self._flushing = False
            except asyncio.CancelledError:
                # stop() anywhere in the collect/flush path: every caller
                # in this batch and still enqueued gets an error, never a
                # hang. Items a flush step already resolved, or handed to
                # the _pending fetch chain, were removed from `batch` (or
                # have done futures, which _fail skips).
                exc = RuntimeError("batcher stopped mid-batch")
                self._fail(batch, exc)
                self._fail(self._carry, exc)  # parked overflow group
                self._carry.clear()
                while True:
                    try:
                        self._fail([self._queue.get_nowait()], exc)
                    except asyncio.QueueEmpty:
                        break
                raise

    async def _flush(self, batch) -> None:
        if FAULTS.enabled:
            # device_submit injection point (GUBER_FAULT_SPEC): an
            # error fails THIS batch's callers (per-item errors, the
            # same envelope as a real submit failure) and must never
            # kill the flusher task; delay/hang stall the submit path
            # like a wedged device would
            try:
                await FAULTS.inject("device_submit")
            except FaultError as e:
                self._fail(batch, e)
                return
        decide_items = [
            b for b in batch if b[0] in ("decide", "decide_arrays")
        ]
        global_items = [b for b in batch if b[0] == "globals"]
        # batch_queue stage: enqueue -> collect, per frame-flagged
        # caller group; traced groups get the same span regardless of
        # frame flag
        t_collect = time.monotonic()
        for it in decide_items:
            m = it[-2]
            if m.frame:
                STAGES.add("batch_queue", t_collect - m.t)
            if m.trace is not None:
                m.trace.add_span("batch_queue", start=m.t, end=t_collect)

        if global_items:
            # coalesced install (r10): ONE backend call per flush batch
            # instead of one per caller group. Safe to concatenate:
            # installs are last-writer-wins upserts applied in list
            # order, identical to the former sequential per-group calls;
            # the total is bounded by batch_limit (collect_batch weighs
            # update rows like decide rows), which config.validate pins
            # under the engine's bucket ladder. It runs on the submit
            # thread, serialized with every other store mutation (the
            # store is updated in place). Per-caller futures still
            # resolve/fail individually.
            all_updates = [
                u for _, updates, _m, _fut in global_items
                for u in updates
            ]
            try:
                await asyncio.get_running_loop().run_in_executor(
                    self._submit_pool, self.backend.update_globals,
                    all_updates,
                )
            except Exception as e:
                for _, _updates, _m, fut in global_items:
                    if not fut.done():
                        fut.set_exception(e)
            else:
                for _, _updates, _m, fut in global_items:
                    if not fut.done():
                        fut.set_result(None)
            # a cancel mid-call propagates to _run's handler, which fails
            # this and every remaining item in the batch

        if not decide_items:
            return
        if self.prep_at_arrival:
            # merge-combine path (r9): every group is (or can be) a
            # pre-sorted run; the submit thread merges runs instead of
            # re-sorting the flattened batch. Object-only batches ride
            # it too — their conversion/hashing happened at arrival.
            await self._flush_merged(decide_items, t_collect)
            return
        if any(b[0] == "decide_arrays" for b in decide_items):
            # mixed/array batch: flatten everything to dense arrays and
            # take the array submit path
            await self._flush_arrays(decide_items, t_collect)
            return
        reqs = [r for it in decide_items for r in it[1]]
        gnp = [g for it in decide_items for g in it[2]]
        # pipelined path: submit now (host presort + async dispatch);
        # fetch in a background task so the flusher can collect and
        # submit the NEXT batch while the device computes this one.
        await self._submit_pipelined(
            lambda: self.backend.decide_submit(reqs, gnp),
            decide_items,
            lambda handle, submit_s: self._finish(
                handle, decide_items, submit_s, t_collect
            ),
        )

    async def _submit_pipelined(
        self, submit_call, decide_items, finish_factory
    ) -> None:
        """The pipelined paths' shared submit discipline: semaphore
        admission (bounds outstanding batches at fetch_depth), shielded
        executor submit, release/fail on every exit, and ownership
        transfer of the live batch to the fetch task. A cancel while
        waiting for a slot reaches _run's handler with nothing
        submitted. `submit_call` runs on the single submit thread, so
        per-batch host work (flatten/convert/presort) belongs inside it
        — off the event loop AND inside the failure guard."""
        await self._inflight.acquire()
        # t0 AFTER admission: under a saturated pipeline the acquire
        # blocks for up to a batch period, which is queue wait, not
        # launch cost — DEVICE_LAUNCH_MS must not double-count it
        t0 = time.monotonic()
        # shield: a stop() mid-submit must not strand these futures —
        # the submit thread finishes either way (the store mutation has
        # already been dispatched), so fail the batch and propagate.
        loop = asyncio.get_running_loop()
        submit_fut = asyncio.ensure_future(
            loop.run_in_executor(self._submit_pool, submit_call)
        )
        try:
            handle = await asyncio.shield(submit_fut)
        except asyncio.CancelledError:
            # consume the shielded submit's outcome so an exception is
            # not logged as unretrieved at GC; a returned handle is
            # abandoned — the dispatched batch's store mutation stands,
            # the same contract as a crash after dispatch. _run's handler
            # fails the batch's futures.
            self._inflight.release()
            submit_fut.add_done_callback(
                lambda t: t.cancelled() or t.exception()
            )
            raise
        except Exception as e:
            self._inflight.release()
            self._fail(decide_items, e)
            return
        submit_s = time.monotonic() - t0
        STAGES.add("submit_host", submit_s)
        task = asyncio.ensure_future(finish_factory(handle, submit_s))
        # hold the reference until done (stop() drains the set); discard
        # on completion so an idle batcher doesn't pin the last batches'
        # requests/responses until the next flush
        self._pending.add(task)
        task.add_done_callback(self._pending.discard)
        # this batch now belongs to its fetch task (stop() awaits it): a
        # later cancel must not fail its futures from _run. _live_batch
        # is the same list object _run handed to _flush.
        self._live_batch.clear()

    def _prep_of(self, it):
        """The arrival-prep future riding a decide queue tuple (None =
        un-prepped; flush preps it on the submit thread)."""
        return it[3] if it[0] == "decide" else it[2]

    async def _flush_merged(self, decide_items, t_collect) -> None:
        """Merge-combine flush (r9): resolve every group's pre-sorted
        run (arrival prep result, or flush-time prep for stragglers),
        k-way merge the runs into one sorted batch, and dispatch — no
        concat + full argsort anywhere. The submit-thread interior is
        stage-attributed as prep (fallback prep + waiting out unfinished
        arrival preps), merge, and dispatch; with arrival prep keeping
        up, prep ~ 0 and merge+dispatch are all that remains serialized.
        Runs inside submit_call so a conversion error fails THIS batch's
        callers, never the flusher task."""
        lens = [
            it[1]["key_hash"].shape[0]
            if it[0] == "decide_arrays"
            else len(it[1])
            for it in decide_items
        ]

        def submit_call():
            t0 = time.monotonic()
            runs = []
            for it in decide_items:
                p = self._prep_of(it)
                if p is not None:
                    runs.append(_prep_result(p))
                elif it[0] == "decide":
                    runs.append(
                        self.backend.prep_reqs(
                            it[1], [bool(g) for g in it[2]]
                        )
                    )
                else:
                    runs.append(self.backend.prep_group(it[1]))
            t1 = time.monotonic()
            merged = self.backend.merge_prepped(runs)
            t2 = time.monotonic()
            handle = self.backend.decide_submit_merged(merged)
            t3 = time.monotonic()
            STAGES.add("prep", t1 - t0)
            STAGES.add("merge", t2 - t1)
            STAGES.add("dispatch", t3 - t2)
            return handle

        await self._submit_pipelined(
            submit_call,
            decide_items,
            lambda handle, submit_s: self._finish_arrays(
                handle, decide_items, lens, submit_s, t_collect
            ),
        )

    async def _flush_arrays(self, decide_items, t_collect) -> None:
        """Array-path sibling of the pipelined branch in _flush: convert
        request-object groups, concatenate all groups into one dense
        field set, submit once, and let _finish_arrays slice responses
        back per group. The flatten runs inside submit_call — on the
        submit thread, where a conversion error (e.g. an out-of-int64
        value from a JSON caller) fails THIS batch instead of killing
        the flusher task."""
        # group lengths are exception-free to read and needed for the
        # response slicing regardless of submit outcome
        lens = [
            it[1]["key_hash"].shape[0]
            if it[0] == "decide_arrays"
            else len(it[1])
            for it in decide_items
        ]

        def submit_call():
            # flush-time prep baseline: record the same prep/dispatch
            # sub-stages the merged path does (merge has no analogue —
            # the full argsort hides inside decide_submit_arrays'
            # dispatch), so the BENCH_SUBMIT_r9 A/B compares the same
            # submit-thread interior either way
            t0 = time.monotonic()
            parts = []
            for it in decide_items:
                if it[0] == "decide":
                    parts.append(
                        self.backend.arrays_from_reqs(
                            it[1], [bool(g) for g in it[2]]
                        )
                    )
                else:
                    f = it[1]
                    if "gnp" not in f:
                        f = dict(f)
                        f["gnp"] = np.zeros(f["key_hash"].shape[0], bool)
                    parts.append(f)
            fields = {
                k: (
                    parts[0][k]
                    if len(parts) == 1
                    else np.concatenate([p[k] for p in parts])
                )
                for k in self.backend.ARRAY_FIELDS
            }
            t1 = time.monotonic()
            handle = self.backend.decide_submit_arrays(fields)
            t2 = time.monotonic()
            STAGES.add("prep", t1 - t0)
            STAGES.add("dispatch", t2 - t1)
            return handle

        await self._submit_pipelined(
            submit_call,
            decide_items,
            lambda handle, submit_s: self._finish_arrays(
                handle, decide_items, lens, submit_s, t_collect
            ),
        )

    async def _finish_arrays(
        self, handle, decide_items, lens, submit_s, t_collect
    ):
        t1 = time.monotonic()
        loop = asyncio.get_running_loop()
        try:
            status, limit, remaining, reset = await loop.run_in_executor(
                self._fetch_pool, self.backend.decide_wait_arrays, handle
            )
        except Exception as e:
            self._fail(decide_items, e)
            return
        finally:
            self._inflight.release()
            STAGES.add("fetch_wait", time.monotonic() - t1)
        k = 0
        for it, n in zip(decide_items, lens):
            span = (
                status[k : k + n],
                limit[k : k + n],
                remaining[k : k + n],
                reset[k : k + n],
            )
            k += n
            fut = it[-1]
            if fut.done():
                continue
            if it[0] == "decide":
                fut.set_result(self.backend.resps_from_arrays(*span))
            else:
                fut.set_result(span)
        # device stage: collect -> responses resolved, per
        # frame-flagged caller group (covers submit + device execute +
        # fetch + pipeline wait)
        dev_span = time.monotonic() - t_collect
        nf = sum(1 for it in decide_items if it[-2].frame)
        if nf:
            STAGES.add("device", dev_span * nf, nf)
        self._trace_device(
            decide_items, t_collect, k,
            extra=dict(
                submit_ms=round(submit_s * 1e3, 3),
                fetch_ms=round((time.monotonic() - t1) * 1e3, 3),
            ),
        )
        try:
            metrics.DEVICE_BATCH_SIZE.observe(k)
            metrics.DEVICE_LAUNCH_MS.observe(
                (submit_s + (time.monotonic() - t1)) * 1e3
            )
            self._observe_cache_stats()
        except Exception:  # pragma: no cover - defensive
            pass

    async def _finish(
        self, handle, decide_items, submit_s: float, t_collect: float
    ):
        t1 = time.monotonic()
        loop = asyncio.get_running_loop()
        try:
            resps = await loop.run_in_executor(
                self._fetch_pool, self.backend.decide_wait, handle
            )
        except Exception as e:
            self._fail(decide_items, e)
            return
        finally:
            self._inflight.release()
            STAGES.add("fetch_wait", time.monotonic() - t1)
        # own cost only: host submit + own fetch span — NOT the time
        # spent queued behind earlier batches, which would double-count
        # device time under steady pipelining
        self._resolve(
            decide_items, resps, submit_s + (time.monotonic() - t1)
        )
        dev_span = time.monotonic() - t_collect
        nf = sum(1 for it in decide_items if it[-2].frame)
        if nf:
            STAGES.add("device", dev_span * nf, nf)
        self._trace_device(
            decide_items, t_collect, len(resps),
            extra=dict(
                submit_ms=round(submit_s * 1e3, 3),
                fetch_ms=round((time.monotonic() - t1) * 1e3, 3),
            ),
        )

    def _fail(self, items, exc: BaseException) -> None:
        # both queue item shapes carry their future last
        for it in items:
            fut = it[-1]
            if not fut.done():
                fut.set_exception(exc)

    def _resolve(self, decide_items, resps, launch_s: float) -> None:
        # resolve callers FIRST: metrics are best-effort and must never
        # be able to kill the flusher task (a dead flusher wedges every
        # future request with no error surfaced). Responses come back
        # flat in flatten order; slice one span per caller group.
        k = 0
        for it in decide_items:
            rs, fut = it[1], it[-1]
            span = resps[k : k + len(rs)]
            k += len(rs)
            if not fut.done():
                fut.set_result(span)
        try:
            metrics.DEVICE_BATCH_SIZE.observe(len(resps))
            metrics.DEVICE_LAUNCH_MS.observe(launch_s * 1e3)
            self._observe_cache_stats()
        except Exception:  # pragma: no cover - defensive
            pass

    def _observe_cache_stats(self) -> None:
        """Forward the backend's monotonic hit/miss counters into
        cache_access_count{type} (reference cache/lru.go:164-176) as
        deltas since the last flush. Backends are duck-typed: anything
        without a dict-shaped stats() is simply not metered."""
        stats_fn = getattr(self.backend, "stats", None)
        if stats_fn is None:
            return
        s = stats_fn()
        if not isinstance(s, dict):
            return
        hits = int(s.get("hits", s.get("hit", 0)))
        misses = int(s.get("misses", s.get("miss", 0)))
        if hits > self._last_hits:
            metrics.CACHE_ACCESS_COUNT.labels(type="hit").inc(
                hits - self._last_hits
            )
        if misses > self._last_misses:
            metrics.CACHE_ACCESS_COUNT.labels(type="miss").inc(
                misses - self._last_misses
            )
        self._last_hits, self._last_misses = hits, misses
        dropped = int(s.get("dropped", 0))
        evictions = int(s.get("evictions", 0))
        if dropped > self._last_dropped:
            metrics.STORE_DROPPED_CREATES.inc(dropped - self._last_dropped)
        if evictions > self._last_evictions:
            metrics.STORE_EVICTIONS.inc(evictions - self._last_evictions)
        self._last_dropped, self._last_evictions = dropped, evictions
