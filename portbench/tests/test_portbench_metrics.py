"""The metric arithmetic: percentiles over all requests, the device's busy
union and idle gaps, and each reader on recorded inputs."""

from __future__ import annotations

import math

import pytest

from portbench import trace
from portbench.load import percentile
from portbench.reference.limiter import Geometry
from portbench.spec import Spec

from conftest import REPO


def test_percentile_nearest_rank_over_all_requests():
    v = list(range(1, 101))  # 1..100
    assert percentile(v, 99) == 99 and percentile(v, 50) == 50 and percentile(v, 100) == 100
    # a failed request is infinitely late: it is the tail, not left out
    assert percentile([0.001] * 98 + [float("inf")] * 2, 99) == math.inf
    assert percentile([0.001] * 99 + [float("inf")], 99) == 0.001


def test_busy_union_and_gaps():
    dev = [(10, 20, "a"), (15, 30, "b"), (40, 50, "a"), (45, 46, "c"), (90, 120, "a")]
    assert trace.merged(dev, 0, 100) == [(10, 30), (40, 50), (90, 100)]
    assert trace.busy_ns(dev, 0, 100) == 20 + 10 + 10
    assert trace.idle_gaps(dev, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    top = trace.top_ops(dev, 0, 100)
    assert top[0] == ["a", (10 + 10 + 10) / 1e9]
    host = [(25, 26, "cudaGraphLaunch", 1), (85, 88, "cudaMemcpyAsync", 2)]
    gaps = trace.named_gaps(dev, host, 0, 100)
    assert gaps[0] == ["host: cudaMemcpyAsync", 40 / 1e9]
    red = trace.reduce(dev, host, 0, 100)
    assert red["idle_share"] == pytest.approx(0.6) and red["events"] == 5


def recorded_run(loop="closed"):
    return dict(
        traffic=dict(loop=loop), geo=Geometry(1024, 16, 2, 4096), setup_s=21.5,
        window=dict(seconds=10.0, rows_in_window=30_000_000, latency_s=[0.004] * 990 + [0.03] * 10,
                    lag_s=[0.0001] * 1000, device_rows=32_768 * 900, device_batches=900,
                    stages=dict(merge=dict(mean_ms=1.25, count=900), dispatch=dict(total_s=0.9, count=1000),
                                batch_queue=dict(mean_ms=3.0, count=30_000)),
                    stats=dict(dropped=884_736), replay_s=1.6, replays=900, replay_rows=32_768 * 900),
        profile=dict(busy_ns=1_750_000_000, window_ns=10_000_000_000, rows=32_768_000, events=10,
                     idle_share=0.825),
    )


@pytest.mark.parametrize("name,want", [
    ("served_decisions_per_s.deep", 3_000_000.0),
    ("device_us_per_kdec", 54.25347222222222),
    ("setup_s", 21.5),
    ("request_p99_ms", 4.0),
    ("request_p50_ms.open", 4.0),
    ("generator_lag_p99_ms.open", 0.1),
    ("mean_device_batch.deep", 32_768.0),
    ("mean_device_batch.open", 32_768.0),
    ("merge_ms.deep", 1.25),
    ("dispatch_ms.deep", 0.9),
    ("batch_queue_ms.open", 3.0),
    ("decide_device_us_per_kdec.deep", 53.40576171875),
    ("sketch_served_share.deep", 0.03),
    ("device_idle_share.deep", 0.825),
    ("device_idle_share.open", 0.825),
])
def test_readers_on_recorded_inputs(name, want):
    spec = Spec(REPO / "BENCHMARK.json")
    assert spec.reader(name).read(recorded_run()) == pytest.approx(want)


def test_readers_find_nothing_return_nothing():
    spec = Spec(REPO / "BENCHMARK.json")
    run = recorded_run(loop="open")
    run["profile"] = None
    run["window"]["stages"] = {}
    run["window"]["device_batches"] = 0
    run["geo"] = Geometry(1024, 16)
    run["window"]["replays"] = 0
    for name in ("served_decisions_per_s.deep", "device_us_per_kdec", "device_idle_share.deep", "decide_device_us_per_kdec.deep",
                 "merge_ms.deep", "mean_device_batch.deep", "sketch_served_share.deep"):
        assert spec.reader(name).read(run) is None, name


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = Spec(REPO / "BENCHMARK.json")
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_writeback_bytes_match_chip_smoke_kernel_case():
    """chip_smoke.py kernel_case: G*W*4 + G*4 + 2*touched*W*4 bytes."""
    from portbench.peaks import HBM_BYTES_PER_S, roofline_share, writeback_bytes

    G, touched = 8192, 8000
    nbytes = writeback_bytes(G, touched)
    assert nbytes == G * 128 * 4 + G * 4 + 2 * touched * 128 * 4
    assert roofline_share(nbytes, nbytes / HBM_BYTES_PER_S) == pytest.approx(1.0)
