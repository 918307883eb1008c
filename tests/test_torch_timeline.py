"""The port's batch timeline on the CPU (serve/stages.py).

The stage clock keeps per-stage totals always; armed, it also keeps
each span's record (name, start, end, thread, batch id). These tests
hold it to its contract:

- disarmed, a record adds to the totals exactly as before and keeps
  nothing else; armed, the list stops at its capacity and counts the
  rest as dropped, and gen-2 collections join it as `gc` spans;
- one DeviceBatcher batch over the CPU TorchBackend (two-tier, with the
  promoter) yields every span of the batch under one batch id, on the
  loop, submit and fetch threads, each child inside its parent; the
  request-object path without arrival prep records its own set;
- arming changes no decision;
- `groups` in the backend's stats counts the distinct keys a batch
  holds, flat and on a mesh, and leaves GLOBAL gossip chunks out as
  the other counters do;
- the mesh's merged submit records the flat engine's children.
"""

import asyncio
import gc

import numpy as np
import pytest

import gubernator_tpu_torch.api.types as types
import gubernator_tpu_torch.serve.promoter as promoter
from gubernator_tpu_torch.core.sketches import SketchConfig
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import MeshBackend, TorchBackend
from gubernator_tpu_torch.serve.batcher import DeviceBatcher
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.instance import Instance
from gubernator_tpu_torch.serve.stages import (
    PER_BATCH,
    PER_TICK,
    STAGES,
    StageStats,
    wall_records,
)

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7976"
GOLDEN = np.uint64(0x9E3779B97F4A7C15)

BATCH_SPANS = {
    "collect": "loop", "submit_call": "submit", "prep": "submit", "merge": "submit",
    "dispatch": "submit", "observe": "submit", "launch": "submit", "readback": "submit",
    "fetch_sync": "fetch", "unpack": "fetch", "resolve": "loop",
}


def _role(thread: str) -> str:
    if thread.startswith("guber-submit"):
        return "submit"
    if thread.startswith("guber-fetch"):
        return "fetch"
    return "loop"


def _group(rng, n: int, keys: int) -> dict:
    return dict(
        key_hash=rng.integers(1, keys + 1, n).astype(np.uint64) * GOLDEN,
        hits=rng.choice([0, 1, 2], n).astype(np.int64),
        limit=rng.choice([3, 100], n).astype(np.int64),
        duration=rng.choice([1000, 60_000], n).astype(np.int64),
        algo=rng.choice([0, 1], n).astype(np.int32),
    )


@pytest.fixture
def now(monkeypatch):
    clock = [T0]
    monkeypatch.setattr(types, "millisecond_now", lambda: clock[0])
    monkeypatch.setattr(promoter, "OBSERVE_MIN_INTERVAL_S", 0.0)
    return clock


async def _instance(now) -> Instance:
    conf = ServerConfig(
        grpc_address=ADDR, behaviors=BehaviorConfig(global_sync_wait=600.0),
        device_batch_limit=1024, sketch_sync_wait=600.0,
    )
    inst = Instance(conf, TorchBackend(
        StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024),
        sketch=SketchConfig(2, 1 << 12, 4), device="cpu",
    ))
    inst.start()
    await inst.set_peers([types.PeerInfo(address=ADDR, is_owner=True)])
    inst.shed.now_fn = lambda: now[0]
    return inst


def test_disarmed_clock_keeps_totals_only():
    st = StageStats()
    calls = [("merge", 0.25, 1, None), ("dispatch", 0.5, 1, 123.0), ("device", 0.75, 3, None),
             ("merge", 0.125, 1, 7.0)]
    want = {}
    for name, seconds, n, end in calls:
        st.add(name, seconds, n, end=end, batch=9)
        total, count = want.get(name, (0.0, 0))
        want[name] = (total + seconds, count + n)
    snap = st.snapshot()["stages"]
    assert {k: (v["total_s"], v["count"]) for k, v in snap.items()} == want
    assert st.disarm_timeline() is None


def test_armed_clock_keeps_records_up_to_its_capacity():
    st = StageStats()
    st.arm_timeline(3)
    st.add("merge", 0.001, end=10.0, batch=4)
    st.bind_batch(5)
    st.add("launch", 0.002)
    st.bind_batch(None)
    for _ in range(3):
        st.add("unpack", 0.001)
    tl = st.disarm_timeline()
    assert tl["dropped"] == 2 and len(tl["records"]) == 3
    name, start, end, _thread, batch = tl["records"][0]
    assert (name, start, end, batch) == ("merge", 9_999_000_000, 10_000_000_000, 4)
    assert tl["records"][1][4] == 5 and tl["records"][2][4] is None
    # the totals hold every record, the dropped ones too
    assert st.snapshot()["stages"]["unpack"]["count"] == 3
    (m0, w0), (m1, w1) = tl["arm"], tl["disarm"]
    assert m1 >= m0 and w1 >= w0
    st.add("merge", 0.001)  # disarmed again: nothing kept
    assert st.disarm_timeline() is None


def test_armed_clock_times_gen2_collections():
    st = StageStats()
    before = list(gc.callbacks)
    st.arm_timeline(16)
    gc.collect()
    tl = st.disarm_timeline()
    assert gc.callbacks == before
    spans = [r for r in tl["records"] if r[0] == "gc"]
    assert spans and all(r[1] <= r[2] and r[4] is None for r in spans)
    assert st.snapshot()["stages"]["gc"]["count"] == len(spans)
    assert "gc" in PER_TICK


def test_wall_records_map_through_the_clock_pairs():
    tl = dict(records=[("x", 1_000, 3_000, "t", 1)], arm=(0, 10_000), disarm=(4_000, 18_000))
    assert wall_records(tl) == [("x", 12_000, 16_000, "t", 1)]


def test_one_batch_yields_every_span_under_one_id(now):
    async def run():
        inst = await _instance(now)
        try:
            rng = np.random.default_rng(3)
            await inst.batcher.decide_arrays(_group(rng, 200, 40))  # warm the top-k fold
            STAGES.arm_timeline(4096)
            try:
                await inst.batcher.decide_arrays(_group(rng, 300, 50))
                await inst.batcher.drain()
                await inst.promoter.flush_once()
            finally:
                tl = STAGES.disarm_timeline()
        finally:
            await inst.stop()
        return tl

    tl = asyncio.run(run())
    assert tl["dropped"] == 0
    recs = tl["records"]
    ids = {r[4] for r in recs if r[0] == "submit_call"}
    assert len(ids) == 1
    bid = ids.pop()
    mine = {}
    for name, start, end, thread, batch in recs:
        if batch == bid:
            assert start <= end
            mine.setdefault(name, []).append((start, end, _role(thread)))
    for name, role in BATCH_SPANS.items():
        assert len(mine.get(name, ())) == 1, (name, sorted(mine))
        assert mine[name][0][2] == role, name
    assert set(BATCH_SPANS) <= set(PER_BATCH)

    def span(name):
        return mine[name][0][:2]

    def inside(child, parent):
        (cs, ce), (ps, pe) = span(child), span(parent)
        return ps <= cs and ce <= pe

    for child in ("prep", "merge", "dispatch"):
        assert inside(child, "submit_call"), child
    for child in ("observe", "launch", "readback"):
        assert inside(child, "dispatch"), child
    used = sum(e - s for s, e in (span(c) for c in ("observe", "launch", "readback")))
    assert used <= span("dispatch")[1] - span("dispatch")[0]
    assert span("collect")[1] <= span("submit_call")[0]
    assert span("submit_call")[1] <= span("fetch_sync")[0] <= span("unpack")[0]
    assert span("unpack")[1] <= span("resolve")[0]
    ticks = [r for r in recs if r[0] == "promoter_tick"]
    assert len(ticks) == 1 and ticks[0][4] is None and _role(ticks[0][3]) == "loop"


def test_decisions_are_identical_armed_and_disarmed(now):
    async def run(armed: bool):
        inst = await _instance(now)
        now[0] = T0
        rng = np.random.default_rng(11)
        out = []
        if armed:
            STAGES.arm_timeline(1 << 14)
        try:
            for step in range(6):
                now[0] += int(rng.choice([1, 50, 5000]))
                got = await inst.batcher.decide_arrays(_group(rng, int(rng.integers(1, 600)), 80))
                out.append([np.asarray(a).copy() for a in got])
            await inst.promoter.flush_once()
        finally:
            tl = STAGES.disarm_timeline() if armed else None
            await inst.stop()
        state = (inst.backend.engine.store.data.clone(), inst.backend.engine.sketch.data.clone())
        return out, state, inst.backend.stats(), tl

    off, on = asyncio.run(run(False)), asyncio.run(run(True))
    assert on[3] is not None and on[3]["records"]
    for a, b in zip(off[0], on[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert all(bool((x == y).all()) for x, y in zip(off[1], on[1]))
    assert off[2] == on[2]


def _merged_submit(backend, fields, now_ms):
    runs = [backend.prep_group(fields)]
    return backend.decide_wait_arrays(
        backend.decide_submit_merged(backend.merge_prepped(runs), now_ms))


@pytest.mark.parametrize("mesh", [False, True], ids=["flat", "mesh"])
def test_groups_count_the_distinct_keys_of_a_batch(mesh):
    store = StoreConfig(rows=16, slots=16)
    backend = (MeshBackend(store, devices=["cpu", "cpu"], buckets=(64, 256, 1024)) if mesh
               else TorchBackend(store, buckets=(64, 256, 1024), device="cpu"))
    rng = np.random.default_rng(5)
    want = 0
    for n, keys in ((300, 50), (17, 17), (700, 400)):
        f = _group(rng, n, keys)
        want += len(np.unique(f["key_hash"]))
        _merged_submit(backend, f, T0)
    f = dict(_group(rng, 90, 30), gnp=np.zeros(90, bool))
    want += len(np.unique(f["key_hash"]))
    backend.decide_wait_arrays(backend.decide_submit_arrays(f, T0))
    assert backend.stats()["groups"] == want
    assert backend.stats()["batches"] == 4


@pytest.mark.parametrize("mesh", [False, True], ids=["flat", "mesh"])
def test_merged_submit_records_the_dispatch_children(mesh):
    store = StoreConfig(rows=16, slots=16)
    backend = (MeshBackend(store, devices=["cpu", "cpu"], buckets=(64, 256, 1024)) if mesh
               else TorchBackend(store, buckets=(64, 256, 1024), device="cpu"))
    seen = []
    backend.set_hot_observer(seen.append)
    rng = np.random.default_rng(8)
    STAGES.arm_timeline(256)
    try:
        STAGES.bind_batch(77)
        _merged_submit(backend, _group(rng, 200, 60), T0)
    finally:
        STAGES.bind_batch(None)
        tl = STAGES.disarm_timeline()
    names = [r[0] for r in tl["records"] if r[4] == 77]
    assert names == ["observe", "launch", "readback", "fetch_sync", "unpack"]
    assert len(seen) == 1


def test_object_path_records_its_spans_under_one_id():
    """Request objects without arrival prep take decide_submit and
    _finish: the submit body, the engine's children, the fetch and the
    resolve carry the batch id as on the array paths."""
    backend = TorchBackend(StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024), device="cpu")
    backend.set_hot_observer(lambda req: None)
    reqs = [types.RateLimitReq(name="svc", unique_key=f"k{i % 23}", hits=1, limit=10,
                               duration=60_000) for i in range(90)]

    async def run():
        batcher = DeviceBatcher(backend, batch_limit=1024, prep_at_arrival=False)
        batcher.start()
        STAGES.arm_timeline(1024)
        try:
            got = await batcher.decide(reqs, [False] * len(reqs))
            await batcher.drain()
        finally:
            tl = STAGES.disarm_timeline()
            await batcher.stop()
        return got, tl

    got, tl = asyncio.run(run())
    assert len(got) == len(reqs)
    ids = {r[4] for r in tl["records"] if r[0] == "submit_call"}
    assert len(ids) == 1 and None not in ids
    bid = ids.pop()
    mine = {r[0]: _role(r[3]) for r in tl["records"] if r[4] == bid}
    assert mine == {
        "collect": "loop", "submit_call": "submit", "observe": "submit", "launch": "submit",
        "readback": "submit", "submit_host": "loop", "fetch_sync": "fetch", "unpack": "fetch",
        "fetch_wait": "loop", "resolve": "loop",
    }
    assert backend.stats()["groups"] == 23


def test_gossip_chunks_count_no_groups():
    """apply_global_hits charges GLOBAL hits through the decide funnel
    with the observer and the stats off: `groups` stays with them."""
    backend = TorchBackend(StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024), device="cpu")
    rng = np.random.default_rng(9)
    f = _group(rng, 120, 40)
    _merged_submit(backend, f, T0)
    before = backend.stats()
    backend.engine.apply_global_hits(f["key_hash"], f["hits"], f["limit"], f["duration"], T0)
    assert backend.engine.gossip_chunks == 1
    assert backend.stats() == before
    assert before["groups"] == len(np.unique(f["key_hash"]))
