"""The batch timeline beside the device trace (portbench/timeline.py), the
readers that read the port's new spans and counter, and the runner that
arms the timeline across a traced slice (portbench/timeline_run.py):

- the attribution on recorded intervals: the five categories partition
  the idle time exactly, the priority order holds, and a record clipped
  at the markers, or overlapping another, counts once;
- the attribution along the path of the batch that ended each gap: the
  steps partition each gap, in their order;
- each new reader on recorded inputs and on a tiny-config CPU run;
- the existing readers read the same values when the run carries the
  new stages, counter and slice keys beside the old ones.
"""

from __future__ import annotations

import json
import random

import pytest

from portbench import timeline
from portbench.spec import Spec

from conftest import REPO
from test_portbench_metrics import recorded_run

LOOP, SUBMIT, FETCH = "MainThread", "guber-submit_0", "guber-fetch_0"

WINDOW_METRICS = ["observe_ms.deep", "promoter_tick_ms.deep", "launch_ms.deep",
                  "readback_ms.deep", "submit_busy_share.deep", "rows_per_group.deep"]
IDLE_METRICS = ["idle_submit_share.deep", "idle_fetch_share.deep", "idle_loop_share.deep",
                "idle_unattributed_share.deep"]


def test_categories_partition_the_idle_time_in_priority_order():
    recs = [
        ("collect", 0, 15, LOOP, 1),
        ("submit_call", 10, 40, SUBMIT, 1),
        ("merge", 12, 20, SUBMIT, 1),
        ("fetch_sync", 30, 60, FETCH, 1),
        ("collect", 50, 90, LOOP, 2),
        ("encode", 85, 95, LOOP, None),  # another span of the loop thread
        ("gc", 92, 100, SUBMIT, None),
        ("gc", 35, 38, FETCH, None),  # a collection inside submit_call is gc's
        ("device", 0, 200, LOOP, 1),  # a wait: never attributed
        ("batch_queue", 100, 120, LOOP, 2),
    ]
    got = timeline.attribute([(0, 120)], recs)
    assert got == dict(gc=8 + 3, submit=30 - 3, fetch=20, loop=10 + 35 - 3, unattributed=20)
    assert sum(got.values()) == 120


def test_records_clipped_at_the_markers_or_overlapping_count_once():
    recs = [("submit_call", -50, 20, SUBMIT, 1), ("submit_call", 5, 25, SUBMIT, 2),
            ("resolve", 18, 60, LOOP, 1), ("unpack", 22, 61, FETCH, 1)]
    idle = [(0, 30), (40, 55)]
    got = timeline.attribute(idle, recs)
    assert got == dict(submit=25, fetch=5 + 15, loop=0, gc=0, unattributed=0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attribution_matches_a_nanosecond_count(seed):
    rng = random.Random(seed)
    names = ["submit_call", "fetch_sync", "unpack", "resolve", "collect", "promoter_tick",
             "gc", "device", "encode", "launch"]
    threads = [LOOP, SUBMIT, FETCH]
    recs = []
    for _ in range(40):
        s = rng.randrange(-20, 300)
        recs.append((rng.choice(names), s, s + rng.randrange(0, 40), rng.choice(threads), None))
    recs.append(("collect", 0, 1, LOOP, None))  # the loop thread is known
    idle = timeline.union((s, s + rng.randrange(1, 30)) for s in rng.sample(range(0, 280), 12))
    got = timeline.attribute(idle, recs)
    cats = timeline.category_spans(recs)
    want = dict.fromkeys(timeline.ORDER + ("unattributed",), 0)
    for a, b in idle:
        for t in range(a, b):
            for cat in timeline.ORDER:
                if any(s <= t < e for s, e in cats[cat]):
                    want[cat] += 1
                    break
            else:
                want["unattributed"] += 1
    assert got == want and sum(got.values()) == timeline.length(idle)


def test_gaps_are_named_by_the_innermost_span_of_each_thread():
    recs = [("collect", 0, 100, LOOP, 2), ("batch_queue", 0, 100, LOOP, 2),
            ("submit_call", 40, 100, SUBMIT, 1), ("dispatch", 60, 100, SUBMIT, 1),
            ("launch", 70, 90, SUBMIT, 1), ("fetch_sync", 0, 5, FETCH, 0)]
    got = timeline.gaps_by_span([(10, 80), (95, 99)], recs + [("gc", 20, 30, FETCH, None)])
    assert got == [["submit:launch loop:collect gc", 70 / 1e9],
                   ["submit:dispatch loop:collect", 4 / 1e9]]
    assert timeline.gaps_by_span([(200, 210)], recs) == [["no span", 10 / 1e9]]


def _two_batches():
    """Batch 1 in flight on the card; batch 2 collected, handed over and
    submitted; a promoter tick after them."""
    return [
        ("collect", 0, 30, LOOP, 1), ("submit_call", 35, 60, SUBMIT, 1),
        ("launch", 50, 58, SUBMIT, 1),
        ("collect", 70, 100, LOOP, 2), ("submit_call", 104, 160, SUBMIT, 2),
        ("prep", 104, 110, SUBMIT, 2), ("merge", 110, 130, SUBMIT, 2),
        ("dispatch", 130, 160, SUBMIT, 2), ("observe", 131, 136, SUBMIT, 2),
        ("launch", 136, 150, SUBMIT, 2), ("readback", 150, 160, SUBMIT, 2),
        ("gc", 112, 115, FETCH, None),
        ("promoter_tick", 300, 320, LOOP, None),
    ]


def test_a_gap_goes_along_the_path_of_the_batch_that_ended_it():
    recs = _two_batches()
    # the card went idle at 60 and batch 2's upload started it at 140
    bid, got = timeline.gap_path((60, 140), recs)
    assert bid == 2
    assert got == dict(before_collect=10, collect=30, handover=4, prep=6, merge=17, gc=3,
                       observe=5, launch=4, submit_other=1)
    assert sum(got.values()) == 80
    # the device started after the launch returned
    assert timeline.gap_path((140, 155), recs) == (2, dict(launch=10, after_launch=5))
    assert timeline.gap_path((200, 310), recs) == ("promoter_tick", dict(promoter_tick=110))
    assert timeline.gap_path((200, 310), recs, hi=310) == ("slice_end", dict(slice_end=110))
    assert timeline.gap_path((0, 20), recs) == ("unknown", dict(unknown=20))
    # a collection inside a gap no batch ended is still the collection's
    gc = [("gc", 250, 290, FETCH, None)]
    assert timeline.gap_path((200, 310), recs + gc) == ("promoter_tick",
                                                        dict(gc=40, promoter_tick=70))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_path_steps_partition_every_gap(seed):
    rng = random.Random(seed)
    recs, t = [], 0
    for bid in range(1, 30):
        c0 = t + rng.randrange(0, 20)
        c1 = c0 + rng.randrange(0, 30)
        s0 = c1 + rng.randrange(0, 10)
        p1 = s0 + rng.randrange(0, 10)
        m1 = p1 + rng.randrange(0, 20)
        o1 = m1 + rng.randrange(0, 5)
        l1 = o1 + rng.randrange(1, 15)
        s1 = l1 + rng.randrange(0, 5)
        recs += [("collect", c0, c1, LOOP, bid), ("submit_call", s0, s1, SUBMIT, bid),
                 ("prep", s0, p1, SUBMIT, bid), ("merge", p1, m1, SUBMIT, bid),
                 ("observe", m1, o1, SUBMIT, bid), ("launch", o1, l1, SUBMIT, bid)]
        if rng.random() < 0.2:
            g = rng.randrange(c0, s1 + 1)
            recs.append(("gc", g, g + rng.randrange(1, 9), FETCH, None))
        t = s1
    idle = timeline.union((s, s + rng.randrange(1, 40)) for s in rng.sample(range(0, t), 25))
    total, longest = timeline.attribute_paths(idle, recs, hi=t)
    assert sum(total.values()) == timeline.length(idle)
    assert set(total) == set(timeline.PATH + timeline.NOT_A_BATCH)
    assert len(longest) == min(10, len(idle))
    for g in longest:
        assert sum(g["ms"].values()) == pytest.approx(g["seconds"] * 1e3)
    for gap in idle:
        _bid, got = timeline.gap_path(gap, recs, hi=t)
        assert sum(got.values()) == gap[1] - gap[0]


def test_launch_share_counts_graph_launches_inside_launch_spans():
    recs = [("launch", 1_000_000, 1_200_000, SUBMIT, 1), ("observe", 2_000_000, 2_100_000, SUBMIT, 2)]
    host = [(1_100_000, 1_110_000, "cudaGraphLaunch", 1),
            (1_230_000, 1_240_000, "cudaGraphLaunch_v10000", 2),  # within the 50 us slack
            (1_300_000, 1_310_000, "cudaGraphLaunch", 3),  # outside
            (2_050_000, 2_060_000, "cudaGraphLaunch", 4),  # the top-k fold, in observe
            (1_150_000, 1_160_000, "cudaMemcpyAsync", 5)]
    assert timeline.launch_share(host, recs, 0, 10**7) == (0.5, 4)
    assert timeline.launch_share(host, recs, 0, 10**7, owners=("launch", "observe")) == (0.75, 4)
    assert timeline.launch_share(host, recs, 0, 1_000_000) == (0.0, 0)


def test_read_slice_sums_to_the_idle_time():
    dev = [(100, 200, "k"), (500, 560, "k")]
    host = [(90, 95, "cudaGraphLaunch", 1)]
    recs = [("submit_call", 50, 150, SUBMIT, 1), ("launch", 80, 99, SUBMIT, 1),
            ("unpack", 250, 300, FETCH, 1), ("collect", 300, 1000, LOOP, 2),
            ("merge", 2000, 2100, SUBMIT, 3)]
    got = timeline.read_slice(recs, dev, host, 0, 1000)
    assert got["idle_ns"] == 1000 - 160 == sum(got["idle_by"].values())
    assert got["idle_by"] == dict(submit=50, fetch=50, loop=640, gc=0, unattributed=100)
    assert got["launch_share"] == 1.0 and got["graph_launches"] == 1
    assert sum(got["idle_by_path"].values()) == got["idle_ns"]
    assert len(got["timeline"]) == 4  # the record past the slice's end is left out


def _run_with_new_keys():
    run = recorded_run()
    run["window"]["stages"].update(
        observe=dict(total_s=1.8, count=900, mean_ms=2.0), launch=dict(total_s=0.9, count=900),
        readback=dict(total_s=0.09, count=900), promoter_tick=dict(total_s=0.5, count=50),
        submit_call=dict(total_s=7.0, count=900))
    run["window"]["stats"]["groups"] = 32_768 * 900 // 4
    run["profile"].update(idle_ns=8_250_000_000, idle_by=dict(
        submit=5_000_000_000, fetch=1_000_000_000, loop=2_000_000_000, gc=50_000_000,
        unattributed=200_000_000), idle_gaps_by_span=[["submit:merge", 0.01]])
    return run


@pytest.mark.parametrize("name,want", [
    ("observe_ms.deep", 2.0), ("promoter_tick_ms.deep", 10.0), ("launch_ms.deep", 1.0),
    ("readback_ms.deep", 0.1), ("submit_busy_share.deep", 0.7), ("rows_per_group.deep", 4.0),
    ("idle_submit_share.deep", 5 / 8.25), ("idle_fetch_share.deep", 1 / 8.25),
    ("idle_loop_share.deep", 2 / 8.25), ("idle_unattributed_share.deep", 0.2 / 8.25),
])
def test_new_readers_on_recorded_inputs(name, want):
    spec = Spec(REPO / "BENCHMARK.json")
    assert spec.reader(name).read(_run_with_new_keys()) == pytest.approx(want)


def test_new_readers_find_nothing_in_a_parent_run():
    """A program without the new spans and counter, and a slice without the
    timeline: every new reader returns None."""
    spec = Spec(REPO / "BENCHMARK.json")
    for name in WINDOW_METRICS + IDLE_METRICS:
        assert spec.reader(name).read(recorded_run()) is None, name


@pytest.mark.parametrize("name", [
    "served_decisions_per_s.deep", "device_us_per_kdec", "setup_s", "mean_device_batch.deep",
    "merge_ms.deep", "dispatch_ms.deep", "decide_device_us_per_kdec.deep",
    "sketch_served_share.deep", "device_idle_share.deep", "batch_queue_ms.open",
])
def test_existing_readers_read_the_same_beside_the_new_keys(name):
    spec = Spec(REPO / "BENCHMARK.json")
    assert spec.reader(name).read(_run_with_new_keys()) == spec.reader(name).read(recorded_run())


def test_new_entries_name_layers_the_benchmark_has():
    spec = Spec(REPO / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in spec.bench["per_layer"]}
    cells = {w["name"] for w in spec.bench["workloads"]}
    layers = {m["layer"] for m in per_layer.values() if m["name"] not in WINDOW_METRICS}
    for name in WINDOW_METRICS:
        m = per_layer[name]
        assert m["layer"] in layers and m["moves"] == "device_us_per_kdec"
        assert set(m["workloads"]) <= cells


@pytest.fixture
def timeline_cell(bench_dir, capsys):
    """timeline_cell(workload, argv...) -> (exit code, result) of the
    timeline runner on the CPU, over the tiny benchmark with the new
    window metrics listed for its deep cells."""
    from portbench import timeline_run

    bench_file, root = bench_dir
    bench = json.loads(bench_file.read_text())
    deep = [w["name"] for w in bench["workloads"] if ".deep" in w["name"]]
    for name, unit in zip(WINDOW_METRICS, ["ms", "ms", "ms", "ms", "share", "rows"]):
        bench["per_layer"].append(dict(name=name, unit=unit, better="lower", source="program_span",
                                       layer="batcher and host prep", moves="device_us_per_kdec",
                                       workloads=deep))
    bench_file.write_text(json.dumps(bench))

    def go(workload, *extra):
        rc = timeline_run.main(["--workload", workload, "--seed", str(2**31 + 5), "--seconds",
                                "1.0", *extra], device="cpu", bench_file=bench_file, root=root)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)

    return go


def test_runner_reports_the_new_metrics_on_a_tiny_cpu_run(timeline_cell):
    rc, out = timeline_cell("tiny_two.deep_zipf", "--armed-window", "1")
    assert rc == 0 and out["correct"], out and out["checks"]
    m = out["metrics"]
    assert set(WINDOW_METRICS) - {"promoter_tick_ms.deep"} <= set(m)
    assert set(IDLE_METRICS) <= set(m)
    t = out["timeline"]
    assert sum(t["idle_by"].values()) == t["idle_ns"] > 0
    assert sum(m[k]["value"] for k in IDLE_METRICS) <= 1.0 + 1e-9
    assert t["records"] > 0 and t["dropped"] == 0 and t["window"]["records_per_s"] > 0
    assert len(out["breakdown"]["idle_gaps_by_span"]) >= 1
    assert sum(t["idle_by_path"].values()) == t["idle_ns"]
    assert len(out["breakdown"]["idle_gaps_by_path"]) >= 1
    assert 0.0 < m["submit_busy_share.deep"]["value"] < 1.0 and m["rows_per_group.deep"]["value"] >= 1.0
    assert (m["observe_ms.deep"]["value"] + m["launch_ms.deep"]["value"]
            + m["readback_ms.deep"]["value"]) <= m["dispatch_ms.deep"]["value"]
    assert list(out)[-1] == "checks"


def test_runner_leaves_the_harness_as_it_was(timeline_cell, run_cell):
    from portbench import harness, run

    before = (harness._one_traced_slice, harness.GcClock, run.result_of)
    rc, out = timeline_cell("tiny_exact.deep_zipf_mixed")
    assert rc == 0 and out["correct"]
    assert "observe_ms.deep" not in out["metrics"]  # the exact tier has no observer
    assert (harness._one_traced_slice, harness.GcClock, run.result_of) == before
    rc, plain = run_cell("tiny_exact.deep_zipf_mixed", trace=1)
    assert rc == 0 and "timeline" not in plain and "idle_gaps_by_span" not in plain["breakdown"]
    assert {"launch_ms.deep", "rows_per_group.deep"} <= set(plain["metrics"])
