"""Streaming heavy-hitter promoter/demoter for the sketch cold tier (r13).

The port's copy of gubernator_tpu/serve/promoter.py: `_topk_update` is
plain torch on the engine's device and updates the table tensors in
place under DeviceTopK's lock (the reference jits it and donates them);
everything else is the reference's. File references below are the
reference package's.

The two-tier store (core/kernels.py decide_presorted_sketch) splits keys
by exact-tier residency: keys holding a slot decide exactly, dropped
creates decide from the count-min estimate. Residency, though, is won by
ARRIVAL ORDER (first keys into a bucket keep their ways until expiry) —
not by heat. This module closes that loop, the top-K flow-detection
design from PAPERS.md ("A streaming algorithm and hardware accelerator
for top-K flow detection") mapped onto the serving tier:

- **candidate source** — a DEVICE-SIDE SpaceSaving-shaped top-K table
  (DeviceTopK below, r21): the vmapped parallel heap-cascade update
  from PAPERS.md's top-K flow-detection accelerator replaces the r13
  host-side dict scan, so candidate selection cost no longer scales
  with host-side top-K bookkeeping — matched keys aggregate through a
  vmapped membership probe, unmatched keys segment-aggregate in one
  sort pass, and the i-th heaviest newcomer challenges the i-th
  smallest table slot in parallel with SpaceSaving count inheritance.
  Fed uint64 key hashes (not strings: the hot paths — edge frames, GEB
  fast framing, the zipf benches — never materialize key strings) from
  a rate-limited per-dispatch observer hook on the engine's one
  dispatch funnel, so every door's traffic is seen. The observed
  payload carries each candidate's last-seen (limit, duration), the
  params a promotion needs. Eligibility is the PROMOTABLE_ALGOS
  registry (core/algorithms.py): token only — promotion installs token
  windows, and a sliding/GCRA key pinned into a token window would
  change semantics mid-stream.
- **promotion** — on a flush-tick cadence (GUBER_SKETCH_SYNC_WAIT_MS),
  top candidates not already exact-resident are migrated: the engine
  reads their current-window sketch estimate and installs a token window
  with remaining = max(limit - estimate, 0), reset = the window's end
  (core/engine.py promote_from_sketch) — the key then decides EXACTLY
  for the rest of its window and recreates exactly (byte-identical to a
  fresh key) in the next. Installs ride DeviceBatcher.run_serialized,
  the same submit-thread funnel replication's snapshot reads use, so
  they can never race a store-donating dispatch.
- **shed feed** — candidates promoted at estimate >= limit land in the
  store as frozen over-limit windows; their verdicts are seeded straight
  into the r10 shed cache (serve/shedcache.py seed), so the hottest
  refused keys answer host-side without even the first device trip.
- **demotion** — streaming and lazy: tracked promotions are released
  when their installed window expires (the exact entry dies naturally
  and the key's next window starts wherever it lands), and the
  SpaceSaving counts DECAY geometrically every few ticks so a formerly
  hot key cannot ride its history — under adversarial key churn the
  candidate set turns over instead of ossifying, and the bounded
  SpaceSaving capacity caps promoter memory regardless of key
  cardinality.

With no exact-tier pressure (no dropped creates) the promoter never
fires — every candidate is already resident — which is what keeps
GUBER_SKETCH=1 byte-identical to =0 on under-capacity stores
(tests/test_sketch_tier.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from typing import Dict

import numpy as np
import torch

# NOTE: time is read through the module attribute (api.types
# .millisecond_now), never a from-import: tests pin the serving clock
# by patching that attribute, and a module-level from-import would
# freeze whichever clock was live when this module first loaded
from gubernator_tpu_torch.api import types as api_types
from gubernator_tpu_torch.core.algorithms import PROMOTABLE_ALGOS
from gubernator_tpu_torch.core.graphs import DeviceGraphs, TopKLayout
from gubernator_tpu_torch.core.store import DeviceLike, resolve_device
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.stages import STAGES

log = logging.getLogger("gubernator_tpu_torch.promoter")

#: promotable algorithm ids as an array for the observer's vector mask
_PROMOTABLE_IDS = np.array(sorted(PROMOTABLE_ALGOS), np.int32)

#: int64 sign bit: xor-ing it makes signed order the uint64 order
_SIGN_BIT = -(1 << 63)

#: decay the SpaceSaving counts (halving) every this many flush ticks —
#: the turnover half of demotion; small enough that a churned-away key
#: falls out of the top-K within ~a dozen ticks
DECAY_EVERY_TICKS = 8

#: observer sampling floor: at most one SpaceSaving fold per this many
#: seconds, so the per-dispatch hook costs one monotonic read in the
#: steady state no matter how hot the submit thread runs
OBSERVE_MIN_INTERVAL_S = 0.1

#: heaviest distinct keys folded per sampled batch: the fold runs ON
#: the submit thread, so its cost must stay bounded regardless of
#: batch cardinality — and sampling the per-batch HEAD loses nothing,
#: a heavy hitter that can't make a batch's top slice isn't one
OBSERVE_TOP = 128


def _topk_update(kh_t, cnt_t, kh_b, w_b):
    """One step of the SpaceSaving-shaped top-K table (the reference's
    jitted `_topk_update`, serve/promoter.py:96-148, as plain torch).
    Keys are uint64 hashes held as int64 bit patterns; the table tensors
    `kh_t` / `cnt_t` [K] are updated IN PLACE (the reference donates
    them instead) and returned. Three parallel stages, no host loop:

    1. matched adds: the [B, K] match matrix (the empty-slot key 0 never
       matches); each table slot sums its matched batch weights.
    2. unmatched aggregation: sort the batch by key, run-total each
       equal-key segment, keep each total at the segment's LAST row.
    3. heap-cascade insert: the i-th heaviest new key challenges the
       i-th smallest table slot, inheriting its count (new = slot + w).

    Orders are the reference's: the key sort is uint64 order (the sign
    bit flipped) and stable; the top-m pick is a stable descending sort,
    so equal weights keep the lower index first as lax.top_k does; the
    smallest-slot pick is a stable ascending sort. Padding rows carry
    weight 0 and never match or insert."""
    B = kh_b.shape[0]
    K = kh_t.shape[0]
    valid = w_b > 0
    match = (kh_b[:, None] == kh_t[None, :]) & (kh_t != 0)[None, :] & valid[:, None]
    cnt1 = cnt_t + torch.where(match, w_b[:, None], 0).sum(dim=0)
    # unmatched distinct keys via one sort + segment run totals
    um_w = torch.where(valid & ~match.any(dim=1), w_b, 0)
    order = torch.sort(kh_b ^ _SIGN_BIT, stable=True).indices
    ks = kh_b[order]
    ws = um_w[order]
    pos = torch.arange(B, device=kh_b.device)
    brk = ks[1:] != ks[:-1]
    one = torch.ones(1, dtype=torch.bool, device=kh_b.device)
    is_ldr = torch.cat([one, brk])
    is_last = torch.cat([brk, one])
    csum = torch.cumsum(ws, dim=0)
    ldr_at = torch.cummax(torch.where(is_ldr, pos, 0), dim=0).values
    seg_total = csum - (csum - ws)[ldr_at]
    cand_w = torch.where(is_last, seg_total, 0)
    m = min(B, K)
    top_i = torch.sort(cand_w, descending=True, stable=True).indices[:m]
    top_w = cand_w[top_i]
    top_keys = ks[top_i]
    slots = torch.sort(cnt1, stable=True).indices[:m]  # the m smallest
    old_cnt = cnt1[slots]
    old_kh = kh_t[slots]
    do = top_w > 0
    kh_t[slots] = torch.where(do, top_keys, old_kh)
    cnt_t.copy_(cnt1)
    cnt_t[slots] = torch.where(do, old_cnt + top_w, old_cnt)
    return kh_t, cnt_t


class DeviceTopK:
    """Device-resident SpaceSaving-compatible top-K summary.

    Keeps the SpaceSaving surface the promoter consumes (observe_weighted
    / top_with_payload / decay / _counts) and runs the per-batch update
    as tensor code on `device` (cuda unless the caller passes another).
    Payloads (each key's last-seen (limit, duration)) stay host-side,
    pruned to table residents on each sync. Host mirrors (_counts)
    refresh lazily at read time, not per observe.

    On CUDA the table lives on a stream of its own: its uploads, updates
    and read-backs never wait for the decide batches queued on the
    engine's stream, nor those wait for it. The fold is one CUDA graph
    (core/graphs.py), captured on that stream when the table is built
    (a zero-weight fold, which changes nothing) and replayed by every
    observe: a batch goes up through a pinned staging ring into the
    graph's static buffer (`cuda_graphs=False` folds eagerly instead).
    Every update ends with a non-blocking copy of the table into pinned
    host buffers and an event, and a sync waits on that event only (the
    reference's read waits for its one array the same way).

    Thread safety: observe lands on the engine's submit thread while
    sync/decay run on the promoter's flush loop, and the update writes
    the table tensors in place, so every touch of _kh/_cnt holds _lock."""

    def __init__(self, capacity: int, device: DeviceLike = None, cuda_graphs: bool = True):
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        with self._on_stream():
            self._kh = torch.zeros(self.capacity, dtype=torch.int64, device=self.device)
            self._cnt = torch.zeros(self.capacity, dtype=torch.int64, device=self.device)
        # pinned host mirrors of (_kh, _cnt) and the event of their last
        # copy (CUDA only)
        self._host = (
            tuple(torch.zeros(self.capacity, dtype=torch.int64, pin_memory=True)
                  for _ in range(2))
            if cuda else None
        )
        self._event = None
        self._payloads: Dict[int, tuple] = {}
        self._counts: Dict[int, int] = {}
        self._dirty = False
        self._lock = threading.Lock()
        # the fold's graph (CUDA with graphs on), captured here; its
        # capture seconds, and its counts zeroed after it
        self.graphs = None
        self.capture_s = 0.0
        if cuda and cuda_graphs:
            self.graphs = DeviceGraphs(self.device, TopKLayout(OBSERVE_TOP).nbytes,
                                       stream=self._stream)
            zero = np.zeros(OBSERVE_TOP, np.int64)
            with self._lock, self._on_stream():
                self._fold(zero, zero)
            self.capture_s = self.graphs.capture_s
            self.graphs.zero_counts()

    def _fold(self, kb: np.ndarray, wb: np.ndarray) -> None:
        """One `_topk_update` of a batch (int64 keys and weights) into
        the table, on the table's stream: a replay of its graph, or
        eagerly (the CPU, cuda_graphs=False). The caller holds _lock."""
        if self.graphs is None:
            _topk_update(self._kh, self._cnt, self._upload(kb), self._upload(wb))
            return
        B = kb.shape[0]
        self.graphs.run(
            ("topk", B),
            lambda static: _topk_update(self._kh, self._cnt, *TopKLayout(B).views(static)),
            (kb, wb), lambda: TopKLayout(B),
        )

    def graph_stats(self) -> dict:
        """The fold's graph: whether the table folds graphed, captures
        after the one at build (0: the fold has one shape), replays, and
        the build's capture seconds."""
        g = self.graphs
        return dict(graphed=g is not None, captures=0 if g is None else g.program_captures,
                    replays=0 if g is None else g.program_replays, capture_s=self.capture_s)

    def _on_stream(self):
        return (
            torch.cuda.stream(self._stream)
            if self._stream is not None
            else contextlib.nullcontext()
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self._stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _updated_locked(self) -> None:
        """After an update (on the table's stream): start the read-back."""
        self._dirty = True
        if self._host is not None:
            self._host[0].copy_(self._kh, non_blocking=True)
            self._host[1].copy_(self._cnt, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(self._stream)

    def observe_arrays(self, kh, weights, payloads: Dict) -> None:
        """Fold a pre-aggregated batch (distinct uint64 keys + int64
        weights, at most OBSERVE_TOP rows) into the table."""
        n = int(kh.shape[0])
        kb = np.zeros(OBSERVE_TOP, np.uint64)
        wb = np.zeros(OBSERVE_TOP, np.int64)
        kb[:n] = kh[:OBSERVE_TOP]
        wb[:n] = np.maximum(weights[:OBSERVE_TOP], 0)
        with self._lock, self._on_stream():
            self._fold(kb.view(np.int64), wb)
            self._payloads.update(payloads)
            self._updated_locked()

    def observe_weighted(self, agg: Dict, payloads=None) -> None:
        """SpaceSaving-compat dict entry point."""
        kh = np.fromiter(agg.keys(), np.uint64, len(agg))
        w = np.fromiter(agg.values(), np.int64, len(agg))
        self.observe_arrays(kh, w, dict(payloads or {}))

    def _sync_locked(self) -> None:
        if not self._dirty:
            return
        if self._host is not None:
            self._event.synchronize()
            kh_t, cnt_t = self._host
        else:
            kh_t, cnt_t = self._kh, self._cnt
        kh = kh_t.numpy().view(np.uint64)
        cnt = cnt_t.numpy()
        live = kh != 0
        self._counts = {
            int(k): int(c) for k, c in zip(kh[live], cnt[live])
        }
        self._payloads = {
            k: v for k, v in self._payloads.items() if k in self._counts
        }
        self._dirty = False

    def _sync(self) -> None:
        with self._lock:
            self._sync_locked()

    def decay(self, shift: int = 1) -> None:
        """Geometric turnover: counts halve (>> shift) and zeroed entries
        free their slots."""
        with self._lock:
            with self._on_stream():
                self._cnt >>= shift
                self._kh.masked_fill_(self._cnt <= 0, 0)
                self._updated_locked()
            self._sync_locked()

    def top_with_payload(self, k: int):
        self._sync()
        items = sorted(
            self._counts.items(), key=lambda kv: kv[1], reverse=True
        )[:k]
        return [
            (key, cnt, 0, self._payloads.get(key))
            for key, cnt in items
        ]


class HotTracker:
    """Rate-limited DeviceTopK front-end over dispatched batches.

    observe() runs on the engine's submit thread (the dispatch funnel);
    the numpy pre-aggregation is one np.unique over the batch's valid
    promotable rows, and the table fold is one queued device update —
    paid at most every OBSERVE_MIN_INTERVAL_S."""

    def __init__(self, capacity: int, device: DeviceLike = None):
        self.ss = DeviceTopK(capacity, device)
        self._next = 0.0

    def observe(self, req) -> None:
        now = time.monotonic()
        if now < self._next:
            return
        self._next = now + OBSERVE_MIN_INTERVAL_S
        valid = np.asarray(req.valid, bool)
        algo = np.asarray(req.algo)
        hits = np.asarray(req.hits)
        # PROMOTABLE (token-bucket), hit-carrying rows only: promotion
        # installs token windows (core/engine.py install_windows), so
        # the r21 sketch-servable widening does NOT widen this mask —
        # see core/algorithms.PROMOTABLE_ALGOS; peeks say nothing
        # about heat
        mask = valid & np.isin(algo, _PROMOTABLE_IDS) & (hits > 0)
        if not mask.any():
            return
        kh = np.asarray(req.key_hash, np.uint64)[mask]
        uk, first, counts = np.unique(
            kh, return_index=True, return_counts=True
        )
        if uk.shape[0] > OBSERVE_TOP:
            top = np.argpartition(counts, -OBSERVE_TOP)[-OBSERVE_TOP:]
            uk, first, counts = uk[top], first[top], counts[top]
        lim = np.asarray(req.limit, np.int64)[mask][first]
        dur = np.asarray(req.duration, np.int64)[mask][first]
        payloads = {
            int(uk[i]): (int(lim[i]), int(dur[i]))
            for i in range(uk.shape[0])
        }
        self.ss.observe_arrays(uk, counts.astype(np.int64), payloads)


class SketchPromoter:
    """Owns the promote/demote flush loop for one Instance."""

    def __init__(self, conf, instance):
        self.inst = instance
        self.backend = instance.backend
        self.tick = getattr(conf, "sketch_sync_wait", 0.2)
        self.topk = max(1, getattr(conf, "sketch_topk", 512))
        # track more candidates than we promote per tick so the top-K
        # is stable under SpaceSaving's overestimate churn
        self.tracker = HotTracker(
            capacity=4 * self.topk, device=instance.backend.device
        )
        #: promoted key hash -> installed window's reset_time (unix ms);
        #: released lazily at expiry (the demote half) and HARD-bounded
        #: at 32x topk — long windows under churn would otherwise grow
        #: this by up to topk per tick for the whole window (measured
        #: 30k entries in one zipf100m bench run); past the cap the
        #: earliest-reset entries release first (they were closest to
        #: demotion anyway; a released-but-hot key simply re-screens)
        self._promoted: Dict[int, int] = {}
        self._promoted_cap = 32 * self.topk
        self.promotions = 0
        self.demotions = 0
        self.shed_seeds = 0
        self._tasks: list = []
        self._ticks = 0

    # -- lifecycle (the ReplicationManager shape) ---------------------------

    def start(self) -> None:
        if not self._tasks:
            from gubernator_tpu_torch.serve.global_mgr import supervise

            self.backend.set_hot_observer(self.tracker.observe)
            self._tasks = [
                asyncio.ensure_future(
                    supervise("sketch_promoter", self._run)
                )
            ]

    async def stop(self) -> None:
        self.backend.set_hot_observer(None)
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.tick)
            await self.flush_once()

    # -- the flush tick ------------------------------------------------------

    async def flush_once(self) -> None:
        """One tick, recorded whole as the stage clock's `promoter_tick`
        (its awaits included: the promotion call on the submit thread)."""
        t0 = time.monotonic()
        try:
            await self._tick()
        finally:
            t1 = time.monotonic()
            STAGES.add("promoter_tick", t1 - t0, end=t1)

    async def _tick(self) -> None:
        now = api_types.millisecond_now()
        # demote: release promotions whose installed window expired —
        # the exact entry is dead (lazy expiry) and the key's next
        # window starts wherever the tiers put it
        expired = [h for h, r in self._promoted.items() if now >= r]
        for h in expired:
            del self._promoted[h]
        released = len(expired)
        over = len(self._promoted) - self._promoted_cap
        if over > 0:
            import heapq

            for h, _r in heapq.nsmallest(
                over, self._promoted.items(), key=lambda kv: kv[1]
            ):
                del self._promoted[h]
            released += over
        if released:
            self.demotions += released
            try:
                metrics.SKETCH_DEMOTIONS.inc(released)
            except Exception:  # pragma: no cover - defensive
                pass
        self._ticks += 1
        if self._ticks % DECAY_EVERY_TICKS == 0:
            self.tracker.ss.decay()

        cands = self.tracker.ss.top_with_payload(self.topk)
        todo = [
            (k, p[0], p[1])
            for k, _c, _e, p in cands
            if p is not None and k not in self._promoted
        ]
        if not todo:
            return
        kh = np.array([k for k, _, _ in todo], np.uint64)
        lims = np.array([l for _, l, _ in todo], np.int64)
        durs = np.array([d for _, _, d in todo], np.int64)
        try:
            installed, est, reset, over = (
                await self.inst.batcher.run_serialized(
                    self.backend.promote_hashes, kh, lims, durs, now
                )
            )
        except Exception as e:
            # batcher stopping / transient device failure: candidates
            # stay tracked and the next tick retries
            log.warning("sketch promotion tick failed: %s", e)
            return
        n_inst = int(np.asarray(installed).sum())
        shed = self.inst.shed
        seeded = 0
        for i in range(kh.shape[0]):
            # track EVERY candidate (installed or already-resident) so
            # the tick doesn't re-screen residents until their window
            # turns; reset==window end either way
            self._promoted[int(kh[i])] = int(reset[i])
            if installed[i] and over[i] and shed is not None:
                shed.seed(
                    int(kh[i]), int(lims[i]), int(durs[i]),
                    int(reset[i]), now,
                )
                seeded += 1
        self.promotions += n_inst
        self.shed_seeds += seeded
        try:
            if n_inst:
                metrics.SKETCH_PROMOTIONS.inc(n_inst)
            if seeded:
                metrics.SKETCH_SHED_SEEDS.inc(seeded)
        except Exception:  # pragma: no cover - defensive
            pass

    def stats(self) -> dict:
        return dict(
            promotions=self.promotions,
            demotions=self.demotions,
            shed_seeds=self.shed_seeds,
            tracked=len(self._promoted),
            candidates=len(self.tracker.ss._counts),
        )
