"""The port on the card: tests that need an NVIDIA GPU.

Marked `cuda`; each decides inside the test whether a card is present
and skips with the reason where there is none (the CUDA kernel has no
CPU mode). This file imports neither jax nor gubernator_tpu, so it also
runs on a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance is zero throughout: the kernel and the decide are integer
math, and the card must reproduce the CPU bit for bit.
"""

import ctypes

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.core import scan
from gubernator_tpu_torch.core.engine import TorchEngine
from gubernator_tpu_torch.core.sketches import derive_sketch_config
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.core.writeback import (
    ABLATION_ROWS,
    add_one,
    add_one_plain,
    count_replay,
    run_ends,
    writeback_add,
    writeback_add_plain,
    writeback_deltas,
    writeback_deltas_plain,
    writeback_full,
    writeback_rows,
    writeback_rows_plain,
)
from _torch_cases import (  # tests/, on the path under pytest
    DELTAS_EDGES,
    SCAN_PATTERNS,
    WRITEBACK_EDGES,
    deltas_edge,
    scan_case,
    writeback_edge,
)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the writeback kernel has no CPU mode")


def _recipe(seed: int, buckets: int, B: int, W: int):
    """Sorted buckets with long duplicate runs, way-disjoint delta rows,
    values over all of int32."""
    rng = np.random.default_rng(seed)
    ways = W // 8
    data = rng.integers(-(2**31), 2**31 - 1, (buckets, W), dtype=np.int64).astype(np.int32)
    bkt = np.sort(rng.integers(0, buckets, B)).astype(np.int32)
    lead = np.r_[True, bkt[1:] != bkt[:-1]]
    run = np.arange(B) - np.maximum.accumulate(np.where(lead, np.arange(B), 0))
    way = run % ways
    vals = rng.integers(-(2**31), 2**31 - 1, (B, 8), dtype=np.int64).astype(np.int32)
    vals[rng.random(B) < 0.3] = 0
    drow = np.zeros((B, ways, 8), np.int32)
    drow[np.arange(B), way] = vals
    return data, bkt, drow.reshape(B, W)


@pytest.mark.parametrize(
    "W, buckets, B", [(8, 64, 4096), (32, 512, 2048), (128, 4096, 32768), (128, 1 << 16, 300)]
)
def test_writeback_kernel_matches_plain(W, buckets, B):
    _need_card()
    data, bkt, drow = (torch.from_numpy(x).cuda() for x in _recipe(W + B, buckets, B, W))
    want = writeback_add_plain(data.clone(), bkt, drow)
    before = writeback_add.launches
    got = writeback_add(data, bkt, drow)
    torch.cuda.synchronize()
    assert writeback_add.launches == before + 1
    assert got.data_ptr() == data.data_ptr()
    assert torch.equal(got, want)


def test_native_hasher_builds_on_the_card_host():
    """The card's host builds and loads the native hasher and prep (g++
    at first use): the store hashes XXH64 and the prep is native, so the
    card tests below do not pass on the blake2b-8 fallback."""
    _need_card()
    from gubernator_tpu_torch.core.hashing import using_native_hash
    from gubernator_tpu_torch.native import load_hashlib

    assert load_hashlib() is not None and using_native_hash()


@pytest.mark.parametrize("krows", ABLATION_ROWS)
@pytest.mark.parametrize("W, buckets, B", [(128, 32768, 16384), (32, 512, 2048),
                                          (128, 1 << 16, 301)])
def test_ablation_kernels_match_plain(krows, W, buckets, B):
    """The writeback ablation's three steps (rows, deltas, full) at each
    chunk height, bit for bit against their plain versions, each launch
    counted once in its own counter (writeback_add's is the paths')."""
    _need_card()
    data, bkt, drow = (torch.from_numpy(x).cuda()
                       for x in _recipe(W + B + krows, buckets, B, W))
    counts = (writeback_full.launches, writeback_rows.launches,
              writeback_deltas.launches, writeback_add.launches)
    full = writeback_full(data.clone(), bkt, drow, krows)
    rows = writeback_rows(data.clone(), bkt, krows)
    deltas = writeback_deltas(torch.zeros_like(drow), bkt, drow, krows)
    torch.cuda.synchronize()
    assert (writeback_full.launches, writeback_rows.launches, writeback_deltas.launches,
            writeback_add.launches) == tuple(c + 1 for c in counts[:3]) + counts[3:]
    assert torch.equal(full, writeback_add_plain(data.clone(), bkt, drow))
    # each touched row plus one, once: a row skipped, doubled or misplaced shows
    want_rows = data.clone()
    want_rows[torch.unique(bkt).long()] += 1
    assert torch.equal(rows, writeback_rows_plain(data.clone(), bkt))
    assert torch.equal(rows, want_rows) and not torch.equal(rows, data)
    assert torch.equal(deltas, writeback_deltas_plain(torch.zeros_like(drow), bkt, drow, krows))


@pytest.mark.parametrize("krows", ABLATION_ROWS)
@pytest.mark.parametrize("case", DELTAS_EDGES)
@pytest.mark.parametrize("overlap", [True, False])
def test_deltas_kernel_at_the_tiling_edges(case, krows, overlap):
    """The deltas kernel where its tiling has edges, launched with and
    without the overlap, bit for bit against its plain version, one launch
    counted; rows that end no run stay as the caller left them."""
    _need_card()
    bkt, drow = (torch.from_numpy(x).cuda() for x in deltas_edge(case, krows))
    before = writeback_deltas.launches
    sentinel = torch.full_like(drow, 12345)
    got = writeback_deltas(sentinel.clone(), bkt, drow, krows, overlap=overlap)
    torch.cuda.synchronize()
    assert writeback_deltas.launches == before + 1
    want = writeback_deltas_plain(torch.zeros_like(drow), bkt, drow, krows)
    ends = torch.unique(run_ends(bkt, krows))
    written = torch.zeros(drow.shape[0], dtype=torch.bool, device="cuda")
    written[ends] = True
    assert torch.equal(got[written], want[written])
    assert bool((got[~written] == 12345).all())


@pytest.mark.parametrize("krows", ABLATION_ROWS)
@pytest.mark.parametrize("case", WRITEBACK_EDGES)
@pytest.mark.parametrize("W", [8, 32, 128])
def test_writeback_at_the_tiling_edges(case, krows, W):
    """writeback_add and writeback_full at tiles of `krows` rows, where the
    tiling has edges (tests/_torch_cases.py writeback_edge), bit for bit
    against the plain version over the rows whose bucket lies in the store
    (the kernel skips the others); each launch counted once in its own
    counter."""
    _need_card()
    data, bkt, drow, keep = (torch.from_numpy(x).cuda()
                             for x in writeback_edge(case, krows, W))
    want = writeback_add_plain(data.clone(), bkt[keep], drow[keep])
    before = writeback_add.launches, writeback_full.launches
    got_add = writeback_add(data.clone(), bkt, drow)
    got_full = writeback_full(data.clone(), bkt, drow, krows)
    torch.cuda.synchronize()
    assert (writeback_add.launches, writeback_full.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got_add, want)
    assert torch.equal(got_full, want)


def _edge_types(graph: torch.cuda.CUDAGraph) -> list:
    """The dependency type of every edge of a captured graph kept as a
    cudaGraph_t (CUgraphEdgeData.type: 0 default, 1 programmatic), read
    with cuGraphGetEdges_v2 from libcuda."""
    get_edges = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    get_edges.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert get_edges(raw, None, None, None, ctypes.byref(n)) == 0
    ends = [(ctypes.c_void_p * n.value)() for _ in range(2)]
    data = (ctypes.c_ubyte * (8 * n.value))()  # 8 bytes an edge, type at 2
    assert get_edges(raw, ends[0], ends[1], data, ctypes.byref(n)) == 0
    return [data[8 * i + 2] for i in range(n.value)]


def test_writeback_replayed_from_a_graph_matches_the_eager_calls_on_card():
    """writeback_add captured into a CUDA graph on a side stream (as
    core/graphs.py captures the decide): the capture records one launch a
    call in `writeback_add.captured` and launches nothing, and each launch
    after the first hangs on the one before by a programmatic edge (the
    dependent launch survives capture); two replays leave the store byte
    for byte as the eager calls do, and count_replay counts each replay's
    launches."""
    _need_card()
    batches = [_recipe(60 + i, 4096, 2048, 128) for i in range(3)]
    data = torch.from_numpy(batches[0][0]).cuda()
    sets = [(torch.from_numpy(b).cuda(), torch.from_numpy(d).cuda()) for _, b, d in batches]
    eager = data.clone()
    for _ in range(2):
        for b, d in sets:
            writeback_add(eager, b, d)
    work = data.clone()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    launches, captured = writeback_add.launches, writeback_add.captured
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            for b, d in sets:
                writeback_add(work, b, d)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert writeback_add.captured - captured == len(sets)
    assert writeback_add.launches == launches
    torch.cuda.synchronize()
    assert torch.equal(work, data)  # the capture ran nothing
    assert _edge_types(graph) == [1] * (len(sets) - 1)
    graph.instantiate()
    for _ in range(2):
        graph.replay()
        count_replay(len(sets))
    torch.cuda.synchronize()
    assert writeback_add.launches - launches == 2 * len(sets)
    assert torch.equal(work, eager)
    want = data.clone()
    for _ in range(2):
        for b, d in sets:
            writeback_add_plain(want, b, d)
    assert torch.equal(work, want)


# the segmented scans (csrc/segscan.cu): tiles of 64 rows a warp up to 4
# columns, 32 above; 1 and 63-64 rows are one or two warps' tiles, 1,025
# and 32,769 a ragged last tile, 1,024 rows and up more than 32 tiles of
# totals (the carry's look-back takes more than one step on long segments)
_SCAN_N = (1, 63, 64, 1024, 1025, 7680, 32768, 32769, 131072)


@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("k", [1, 2, 3, 17])
@pytest.mark.parametrize("n", _SCAN_N)
def test_seg_scan_kernel_matches_plain(n, k, pattern):
    """The kernel's sums against seg_scan_plain on the card, bit for bit,
    at every tiling edge and leader pattern, with values whose segment
    sums pass 2^31-1 (they saturate); one launch is counted."""
    _need_card()
    lead, vals = (torch.from_numpy(x).cuda() for x in scan_case(pattern, n, k))
    want = scan.seg_scan_plain(lead, vals)
    before = scan.seg_scan.launches
    got = scan.seg_scan(lead, vals)
    torch.cuda.synchronize()
    assert scan.seg_scan.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, k)
    assert torch.equal(got, want)
    if pattern == "one_segment" and n >= 64:
        assert bool((want == 2**31 - 1).any())  # the saturation engaged


@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("mode", ["start", "end"])
@pytest.mark.parametrize("n", _SCAN_N)
def test_segment_bounds_kernel_match_plain(n, mode, pattern):
    """Each row's segment start (the forward walk) and end (the reverse
    walk) from the kernel against leader_pos_plain / segment_ends_plain,
    with and without a leader at row 0."""
    _need_card()
    lead = torch.from_numpy(scan_case(pattern, n, 1)[0]).cuda()
    fn, plain = ((scan.leader_pos, scan.leader_pos_plain) if mode == "start"
                 else (scan.segment_ends, scan.segment_ends_plain))
    want = plain(lead)
    before = scan.seg_scan.launches
    got = fn(lead)
    torch.cuda.synchronize()
    assert scan.seg_scan.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("width", [1, 2, 16, 17, 32])
@pytest.mark.parametrize("rows", [1, 63, 8192, 32768, 131072])
def test_row_cumsum_kernel_matches_plain(rows, width):
    """Each row's prefix along its columns (the kernel with a segment
    every `width` elements and no flags) against row_cumsum_plain, with
    values near 2^31-1 so that the sums saturate."""
    _need_card()
    x = torch.from_numpy(scan_case("random_runs", rows, width)[1]).cuda()
    want = scan.row_cumsum_plain(x)
    before = scan.seg_scan.launches
    got = scan.row_cumsum(x)
    torch.cuda.synchronize()
    assert scan.seg_scan.launches == before + 1
    assert torch.equal(got, want)


def test_seg_scans_replayed_from_a_graph_match_the_eager_calls_on_card():
    """Scans of every kind at the decide's shapes captured into one CUDA
    graph on a side stream: the capture counts each call in
    `seg_scan.captured` and runs nothing, every grid hangs on the one
    before by a programmatic edge, and each of three replays, on inputs
    rewritten in place, gives the eager calls' results bit for bit while
    count_replay moves `seg_scan.launches` by the calls recorded."""
    _need_card()
    shapes = [(32768, 2), (32768, 17), (8192, 17), (64, 3), (32768, 1)]
    ins = [tuple(torch.from_numpy(x).cuda() for x in scan_case("zipf_runs", n, k))
           for n, k in shapes]
    ways = torch.from_numpy(scan_case("zipf_runs", 32768, 16)[1]).cuda()

    def calls():
        return ([scan.seg_scan(lead, vals) for lead, vals in ins]
                + [scan.segment_ends(ins[1][0]), scan.leader_pos(ins[2][0]),
                   scan.row_cumsum(ways)])

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    launches, captured = scan.seg_scan.launches, scan.seg_scan.captured
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outs = calls()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    recorded = scan.seg_scan.captured - captured
    assert recorded == len(shapes) + 3
    assert scan.seg_scan.launches == launches
    torch.cuda.synchronize()
    edges = _edge_types(graph)
    assert edges and edges == [1] * len(edges)
    graph.instantiate()
    for rep, pattern in enumerate(("random_runs", "all_leaders", "one_segment")):
        for (lead, vals), (n, k) in zip(ins, shapes):
            new_lead, new_vals = scan_case(pattern, n, k, seed=rep + 1)
            lead.copy_(torch.from_numpy(new_lead))
            vals.copy_(torch.from_numpy(new_vals))
        ways.copy_(torch.from_numpy(scan_case(pattern, 32768, 16, seed=rep + 1)[1]))
        before = scan.seg_scan.launches
        graph.replay()
        scan.count_replay(recorded)
        assert scan.seg_scan.launches - before == recorded
        eager = calls()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want), pattern
        plain = ([scan.seg_scan_plain(lead, vals) for lead, vals in ins]
                 + [scan.segment_ends_plain(ins[1][0]), scan.leader_pos_plain(ins[2][0]),
                    scan.row_cumsum_plain(ways)])
        for got, want in zip(outs, plain):
            assert torch.equal(got, want), pattern


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "two_tier"])
def test_decide_graphs_record_and_replay_their_scans_on_card(sketch):
    """Every captured decide of the warmup recorded its six scans (the
    two row-level prefix sums, the per-group count of sticky flips, the
    bucket-segment ends, the writeback plan's sums and its empty-way
    ranks) and every install chunk its three; a replayed decide adds its
    six to `seg_scan.launches`, and so does an eager one."""
    _need_card()
    sk = derive_sketch_config(1) if sketch else None
    now = 1_700_000_000_000
    engines = [TorchEngine(StoreConfig(rows=4, slots=64), buckets=_GRAPH_LADDER, sketch=sk,
                           cuda_graphs=graphed) for graphed in (True, False)]
    for eng in engines:
        eng.warmup(now=now)
    graphs = engines[0].graphs.graphs
    decides = [g for g in graphs.values() if g.decide]
    assert decides and all(g.scans == 6 for g in decides)
    installs = [g for key, g in graphs.items() if key[0].startswith("install")]
    assert installs and all(g.scans == 3 for g in installs)
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 2**64, 600, dtype=np.uint64)
    for step in range(4):
        fields = _graph_batch(rng, pool, step, False)
        counts = []
        for eng in engines:
            before = scan.seg_scan.launches
            eng.decide_arrays(*fields, now + step)
            torch.cuda.synchronize()
            counts.append(scan.seg_scan.launches - before)
        assert counts == [6, 6]
    for eng in engines:
        eng.close()


def test_deltas_rejects_a_misaligned_delta_stream():
    _need_card()
    drow = torch.zeros(65 * 128 + 1, dtype=torch.int32, device="cuda")[1:].view(65, 128)
    bkt = torch.zeros(65, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        writeback_deltas(torch.zeros(65, 128, dtype=torch.int32, device="cuda"), bkt, drow)


# add_one's two kernels (csrc/writeback.cu): within half the L2 a grid-stride
# loop over 8 blocks of 256 threads a SM (1,024 int32 a block a stride);
# beyond it one vector a thread, 1,024 int32 a block, one-shot
@pytest.mark.parametrize("n", [32768 * 128, 4096 * 128 + 3, 1, 100, 4093, 4096,
                               3 * 4096 + 6, "one_stride", 1 << 27, "past_half_l2"])
def test_copy_floor_kernel_matches_plain(n):
    """The copy-floor kernel (x += 1) is bit-identical to x.add_(1),
    including the int32 wrap, at the edges of both kernels: fewer int32
    than a block covers, exactly one grid stride, ragged counts, n % 4 in
    {1, 2, 3} (the tail past the last vector), 512 MiB, and an array just
    past half the L2 (the one-shot kernel, a ragged last block, n % 4 =
    3)."""
    _need_card()
    props = torch.cuda.get_device_properties(0)
    if n == "one_stride":
        n = props.multi_processor_count * 8 * 256 * 4
    elif n == "past_half_l2":
        n = props.L2_cache_size // 8 + 1027
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device="cuda",
                      generator=gen)
    x[0] = 2**31 - 1
    want = add_one_plain(x.clone())
    before = add_one.launches
    got = add_one(x)
    torch.cuda.synchronize()
    assert add_one.launches == before + 1
    assert got.data_ptr() == x.data_ptr()
    assert torch.equal(got, want)
    assert int(got[0]) == -(2**31)


def test_copy_floor_rejects_a_misaligned_start():
    _need_card()
    x = torch.zeros(1025, dtype=torch.int32, device="cuda")[1:]
    before = add_one.launches
    with pytest.raises(ValueError):
        add_one(x)
    assert add_one.launches == before


def test_copy_floor_refuses_past_its_32_bit_offsets():
    """Beyond half the L2 the one-shot kernel's offsets are 32-bit: an
    array of 2^31 vectors is refused by the C entry, and the wrapper
    raises without counting a launch."""
    _need_card()
    x = torch.empty(2**33, dtype=torch.int32, device="cuda")  # 32 GiB, never written
    before = add_one.launches
    with pytest.raises(RuntimeError, match="add_one: kernel launch failed"):
        add_one(x)
    assert add_one.launches == before
    del x
    torch.cuda.empty_cache()


def test_engine_on_card_matches_cpu():
    _need_card()
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 2**64, 2000, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    gpu = TorchEngine(cfg, buckets=(256, 1024))
    cpu = TorchEngine(cfg, buckets=(256, 1024), device="cpu")
    now = 1_700_000_000_000
    before = writeback_add.launches
    for step in range(20):
        now += int(rng.choice([1, 50, 5000]))
        n = int(rng.integers(1, 1025))
        idx = np.minimum(rng.zipf(1.2, n) - 1, pool.shape[0] - 1)
        fields = (
            pool[idx], rng.choice([0, 1, 2], n), rng.choice([3, 100], n),
            rng.choice([1000, 60_000], n), rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )
        for a, b in zip(gpu.decide_arrays(*fields, now), cpu.decide_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert torch.equal(gpu.store.data.cpu(), cpu.store.data), f"step {step}"
    assert writeback_add.launches == before + 20
    assert gpu.stats.snapshot() == cpu.stats.snapshot()


def test_export_install_round_trip_on_card_matches_cpu():
    """A CUDA engine's export_windows (all four algorithms, sticky creates,
    peeks) equals the CPU engine's given the same decides; installing it
    into fresh engines (the restore's lane path) launches writeback_add
    once per install chunk on the card and leaves both stores equal, and
    the flat repartition carries every window."""
    _need_card()
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    gpu = TorchEngine(cfg, buckets=(256,))
    cpu = TorchEngine(cfg, buckets=(256,), device="cpu")
    now = 1_700_000_000_000
    for step in range(8):
        now += int(rng.choice([1, 50, 5000]))
        n = 256
        idx = rng.integers(0, pool.shape[0], n)
        fields = (
            pool[idx], rng.choice([0, 1, 2, 9], n), rng.choice([3, 5, 100], n),
            rng.choice([1000, 60_000], n), (idx % 4).astype(np.int32),
            np.zeros(n, bool),
        )
        for a, b in zip(gpu.decide_arrays(*fields, now), cpu.decide_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
    w = gpu.export_windows(now)
    want = cpu.export_windows(now)
    assert sorted(w) == sorted(want)
    for col in w:
        np.testing.assert_array_equal(w[col], want[col], err_msg=col)
    assert w["key_hash"].shape[0] > 256 and w["is_over"].any()
    assert set(np.unique(w["flags"] & 14).tolist()) == {0, 2, 4, 8}
    assert gpu.last_export["bytes"] == w["key_hash"].shape[0] * 32
    fresh_gpu = TorchEngine(cfg, buckets=(256,))
    fresh_cpu = TorchEngine(cfg, buckets=(256,), device="cpu")
    before = writeback_add.launches
    for eng in (fresh_gpu, fresh_cpu):
        eng.install_windows(
            w["key_hash"], w["limit"], w["remaining"], w["reset_time"], None,
            now=now, duration=w["duration"], ts=w["ts"], flags=w["flags"],
        )
    torch.cuda.synchronize()
    assert fresh_gpu.install_chunks == -(-w["key_hash"].shape[0] // 256)
    assert writeback_add.launches - before == fresh_gpu.install_chunks
    assert torch.equal(fresh_gpu.store.data.cpu(), fresh_cpu.store.data)
    order = np.argsort(w["key_hash"])
    got = fresh_gpu.export_windows(now)
    o2 = np.argsort(got["key_hash"])
    for col in w:
        np.testing.assert_array_equal(got[col][o2], w[col][order], err_msg=col)
    moved = gpu.repartition(now=now)
    assert moved.device.type == "cuda"
    assert torch.equal(moved.store.data.cpu(), fresh_cpu.store.data)


def test_chained_engine_on_card_matches_cpu():
    """Chained batches (chains of 1-4 rows over shared TOKEN ancestors,
    the leaf any algorithm) on the two-tier engine: identical responses
    and store bytes on the card and on the CPU, the sketch untouched, one
    writeback launch a chain decide."""
    _need_card()
    rng = np.random.default_rng(6)
    leaves = rng.integers(0, 2**64, 2000, dtype=np.uint64)
    ancestors = rng.integers(0, 2**64, 8, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    skc = derive_sketch_config(1)
    gpu = TorchEngine(cfg, buckets=(256, 1024), sketch=skc)
    cpu = TorchEngine(cfg, buckets=(256, 1024), device="cpu", sketch=skc)
    now = 1_700_000_000_000
    before = writeback_add.launches
    for step in range(16):
        now += int(rng.choice([1, 50, 5000]))
        depth = rng.integers(1, 5, int(rng.integers(1, 256)))
        kh = np.concatenate([np.append(ancestors[rng.integers(0, 8, d - 1)],
                                       leaves[rng.integers(0, 2000)]) for d in depth])
        leaf = np.concatenate([np.arange(d) == d - 1 for d in depth])
        n = kh.shape[0]
        fields = (
            kh, np.repeat(rng.choice([0, 1, 2], depth.shape[0]), depth),
            np.where(leaf, rng.choice([3, 100], n), rng.choice([5, 40], n)),
            rng.choice([1000, 60_000], n), np.where(leaf, rng.integers(0, 4, n), 0).astype(np.int32),
            np.repeat(np.arange(depth.shape[0]), depth), np.repeat(kh[np.cumsum(depth) - depth], depth),
        )
        for a, b in zip(gpu.decide_chain_arrays(*fields, now), cpu.decide_chain_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert torch.equal(gpu.store.data.cpu(), cpu.store.data), f"step {step}"
    assert not gpu.sketch.data.any()
    assert writeback_add.launches == before + 16
    assert gpu.stats.snapshot() == cpu.stats.snapshot()


@pytest.mark.parametrize("derivation", ["v2", "r13"])
def test_two_tier_engine_on_card_matches_cpu(derivation):
    """The two-tier decide under tier pressure (a pool 4x the store, all
    four algorithms) and a promote: identical responses, store bytes and
    sketch counters on the card and on the CPU; every decide and every
    install chunk launches the writeback kernel once."""
    _need_card()
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    cfg = StoreConfig(rows=16, slots=64)
    skc = derive_sketch_config(1, derivation=derivation)
    gpu = TorchEngine(cfg, buckets=(256, 1024), sketch=skc)
    cpu = TorchEngine(cfg, buckets=(256, 1024), device="cpu", sketch=skc)
    now = 1_700_000_000_000
    before = writeback_add.launches
    for step in range(16):
        now += int(rng.choice([1, 50, 5000]))
        n = int(rng.integers(1, 1025))
        idx = np.minimum(rng.zipf(1.1, n) - 1, pool.shape[0] - 1)
        fields = (
            pool[idx], rng.choice([0, 1, 2], n), rng.choice([3, 100], n),
            rng.choice([1000, 60_000], n), rng.integers(0, 4, n).astype(np.int32),
            rng.random(n) < 0.05,
        )
        for a, b in zip(gpu.decide_arrays(*fields, now), cpu.decide_arrays(*fields, now)):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert torch.equal(gpu.store.data.cpu(), cpu.store.data), f"step {step}"
        assert torch.equal(gpu.sketch.data.cpu(), cpu.sketch.data), f"step {step}"
    assert gpu.stats.snapshot() == cpu.stats.snapshot()
    assert gpu.stats.snapshot()["dropped"] > 0
    keys = pool[:1500]  # 1500 > top rung 1024: two install chunks at most
    lim = np.full(keys.shape[0], 100)
    dur = np.full(keys.shape[0], 60_000)
    g = gpu.promote_from_sketch(keys, lim, dur, now + 1)
    c = cpu.promote_from_sketch(keys, lim, dur, now + 1)
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(gpu.store.data.cpu(), cpu.store.data)
    chunks = -(-int(g[0].sum()) // 1024)
    assert writeback_add.launches == before + 16 + chunks


def test_instance_on_card_matches_cpu(monkeypatch):
    """The serving core (Instance -> DeviceBatcher with arrival prep ->
    TorchBackend) on the card against the same stack on the CPU, one
    caller group at a time under one pinned clock, tier pressure on:
    identical responses, store and sketch bytes, stats, shed entries and
    one promoter tick's promotions."""
    _need_card()
    import asyncio

    import gubernator_tpu_torch.api.types as types
    import gubernator_tpu_torch.serve.promoter as promoter
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
    from gubernator_tpu_torch.serve.instance import Instance

    now = [1_700_000_000_000]
    monkeypatch.setattr(types, "millisecond_now", lambda: now[0])
    monkeypatch.setattr(promoter, "OBSERVE_MIN_INTERVAL_S", 0.0)
    addr = "127.0.0.1:7975"

    async def stack(device):
        conf = ServerConfig(
            grpc_address=addr, behaviors=BehaviorConfig(global_sync_wait=600.0),
            device_batch_limit=1024, sketch_sync_wait=600.0,
        )
        inst = Instance(conf, TorchBackend(
            StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024),
            sketch=SketchConfig(2, 1 << 12, 4), device=device,
        ))
        inst.start()
        await inst.set_peers([types.PeerInfo(address=addr, is_owner=True)])
        inst.shed.now_fn = lambda: now[0]
        return inst

    async def run():
        gpu, cpu = await stack(None), await stack("cpu")
        assert gpu.backend.device.type == "cuda"
        rng = np.random.default_rng(6)
        pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
        before, decides = writeback_add.launches, gpu.backend.stats()["batches"]
        for step in range(12):
            now[0] += int(rng.choice([1, 50, 5000]))
            n = int(rng.integers(1, 1000))
            f = dict(
                key_hash=pool[np.minimum(rng.zipf(1.1, n) - 1, pool.shape[0] - 1)],
                hits=rng.choice([0, 1, 2], n).astype(np.int64),
                limit=rng.choice([3, 100], n).astype(np.int64),
                duration=rng.choice([1000, 60_000], n).astype(np.int64),
                algo=rng.integers(0, 4, n).astype(np.int32),
            )
            a = await gpu.batcher.decide_arrays(dict(f))
            b = await cpu.batcher.decide_arrays(dict(f))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f"step {step}")
            reqs = [types.RateLimitReq(name="s", unique_key=f"k{i % 40}", hits=1,
                                       limit=2, duration=60_000) for i in range(30)]
            ra = await gpu.get_rate_limits(reqs)
            rb = await cpu.get_rate_limits(reqs)
            assert [(r.status, r.remaining, r.reset_time) for r in ra] == [
                (r.status, r.remaining, r.reset_time) for r in rb]
        # one launch per device batch (shed-cache answers launch nothing)
        decides = gpu.backend.stats()["batches"] - decides
        assert decides >= 12 and writeback_add.launches == before + decides
        for inst in (gpu, cpu):
            await inst.promoter.flush_once()
        assert gpu.promoter.stats() == cpu.promoter.stats()
        assert gpu.backend.stats() == cpu.backend.stats()
        assert gpu.backend.stats()["dropped"] > 0
        assert dict(gpu.shed._entries) == dict(cpu.shed._entries)
        assert torch.equal(gpu.backend.engine.store.data.cpu(), cpu.backend.engine.store.data)
        assert torch.equal(gpu.backend.engine.sketch.data.cpu(), cpu.backend.engine.sketch.data)
        await gpu.stop()
        await cpu.stop()

    asyncio.run(run())


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "two_tier"])
def test_timeline_shares_the_profiler_clock_on_card(sketch):
    """A short pipelined serving run (DeviceBatcher, deep batches, two in
    flight) under torch.profiler, the stage clock's timeline armed inside
    the profile: mapped through its clock pairs onto the profiler's clock,
    at least 99% of the decides' graph-launch runtime calls fall inside a
    `launch` span, with 50 us of slack on each side."""
    _need_card()
    import asyncio
    import time

    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.serve.backends import TorchBackend
    from gubernator_tpu_torch.serve.batcher import DeviceBatcher
    from gubernator_tpu_torch.serve.stages import STAGES, wall_records

    backend = TorchBackend(StoreConfig(rows=16, slots=16), buckets=(64, 256, 1024),
                           sketch=SketchConfig(2, 1 << 12, 4) if sketch else None)
    backend.warmup()
    rng = np.random.default_rng(21)
    pool = rng.integers(1, 2**63, 5000, dtype=np.uint64)

    async def serve(seconds):
        batcher = DeviceBatcher(backend, batch_limit=1024, fetch_depth=2, deep_batch=True)
        batcher.start()
        stop = time.monotonic() + seconds

        async def caller():
            while time.monotonic() < stop:
                n = int(rng.integers(1, 256))
                await batcher.decide_arrays(dict(
                    key_hash=pool[np.minimum(rng.zipf(1.2, n) - 1, pool.shape[0] - 1)],
                    hits=np.ones(n, np.int64), limit=np.full(n, 100, np.int64),
                    duration=np.full(n, 60_000, np.int64), algo=np.zeros(n, np.int32)))

        await asyncio.gather(*[caller() for _ in range(8)])
        await batcher.drain()
        await batcher.stop()

    asyncio.run(serve(0.3))  # first uses outside the traced run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        STAGES.arm_timeline(1 << 16)
        try:
            asyncio.run(serve(1.0))
        finally:
            tl = STAGES.disarm_timeline()
    slack = 50_000
    spans = sorted((s - slack, e + slack) for name, s, e, _t, _b in wall_records(tl)
                   if name == "launch")
    calls = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
             for e in prof.profiler.kineto_results.events()
             if "cudaGraphLaunch" in e.name() and "CUDA" not in str(e.device_type())]
    inside = sum(any(s <= c0 and c1 <= e for s, e in spans) for c0, c1 in calls)
    assert tl["dropped"] == 0 and len(spans) >= 20 and len(calls) >= 20
    assert inside >= 0.99 * len(calls), (inside, len(calls), len(spans))


def test_decide_wait_does_not_wait_for_later_work():
    """decide_wait returns once its own batch's copy is done, while work
    queued after that batch still runs on the stream: for a batch whose
    shape is captured at its submit (the graph's first use) and for one
    that replays the graph."""
    _need_card()
    eng = TorchEngine(StoreConfig(rows=16, slots=64), buckets=(256,))
    rng = np.random.default_rng(8)
    n = 200
    kh = rng.integers(0, 2**64, n, dtype=np.uint64)
    ones = np.ones(n, np.int64)
    for i in range(2):
        h = eng.decide_submit(kh, ones, ones * 5, ones * 60_000, np.zeros(n, np.int32),
                              np.zeros(n, bool), 1_700_000_000_000 + i)
        torch.cuda._sleep(2_000_000_000)  # ~1 s of later work on the same stream
        status, *_ = eng.decide_wait(h)
        assert not torch.cuda.current_stream().query(), "decide_wait waited for later work"
        assert (status == 0).all()
        torch.cuda.synchronize()
    assert (eng.graph_count, eng.graphs.captures, eng.graphs.replays) == (1, 1, 1)


_GRAPH_LADDER = (64, 256)  # (B, G) pairs (64, 64), (256, 64), (256, 96), (256, 256)


def _graph_batch(rng, pool, step: int, chain: bool):
    """A batch of step's (B, G) pair of _GRAPH_LADDER: n rows over a
    number of distinct keys that lands on that group rung (chains: rows
    in chains of up to 3, a chain routed by its head)."""
    n, distinct = ((48, 40), (200, 60), (250, 90), (256, 180))[step % 4]
    keys = pool[rng.choice(pool.shape[0], distinct, replace=False)]
    kh = keys[np.r_[np.arange(distinct), rng.integers(0, distinct, n - distinct)]]
    rng.shuffle(kh)
    fields = [kh, rng.choice([0, 1, 1, 2, 40], n), rng.choice([0, 3, 10, 1000], n),
              rng.choice([1, 1000, 60_000, (1 << 30) - 1], n),
              rng.integers(0, 4, n).astype(np.int32)]
    if chain:
        cid = np.arange(n) // 3
        return fields + [cid, kh[cid * 3]]
    return fields + [rng.random(n) < 0.05]


@pytest.mark.parametrize("program", ["exact", "sketch", "chain"])
def test_graph_replays_match_the_eager_decide_on_card(program):
    """The graphed engine (warmup captures every (B, G) pair of a small
    ladder; chains capture on first use) against the eager one
    (cuda_graphs=False) on the same batches, byte for byte: answers,
    stats, store and sketch, with `now` advancing and, between batches,
    a reset, a load_state, a forced rebase and an install_windows (the
    graphs keep pointing at the live tensors). writeback_add's count
    moves by one a decide (an eager warm run or a replay) and one an
    install chunk, and the graphed engine ran no other eager decide."""
    _need_card()
    sk = derive_sketch_config(1) if program == "sketch" else None
    cfg = StoreConfig(rows=4, slots=64)  # small: drops and evictions
    g_eng = TorchEngine(cfg, buckets=_GRAPH_LADDER, sketch=sk)
    e_eng = TorchEngine(cfg, buckets=_GRAPH_LADDER, sketch=sk, cuda_graphs=False)
    now = 1_700_000_000_000
    for eng in (g_eng, e_eng):
        eng.warmup(now=now)
    pairs = 4 * (2 if sk is not None else 1)
    assert (g_eng.graph_count, g_eng.graph_captures, e_eng.graph_count) == (pairs, 0, 0)
    assert g_eng.capture_s > 0 and g_eng.graph_pool_bytes > 0
    rng = np.random.default_rng(12)
    pool = rng.integers(0, 2**64, 600, dtype=np.uint64)
    before = writeback_add.launches
    saved = None
    for step in range(32):
        now += int(rng.choice([1, 50, 1000, 70_000]))
        if step == 8:
            saved = (e_eng.store_numpy(), e_eng.clock.epoch, e_eng.sketch_numpy())
        elif step == 12:
            for eng in (g_eng, e_eng):
                eng.reset()
        elif step == 16:
            for eng in (g_eng, e_eng):
                eng.load_state(*saved)
        elif step == 20:
            now += 1 << 30  # past the epoch's envelope: the store rebases in place
        elif step == 24:
            kh = pool[:100]
            one = np.ones(100, np.int64)
            for eng in (g_eng, e_eng):
                eng.install_windows(kh, one * 9, one * 4, one * (now + 60_000),
                                    np.zeros(100, bool), now)
        fields = _graph_batch(rng, pool, step, program == "chain")
        if program == "chain":
            got, want = (eng.decide_chain_arrays(*fields, now) for eng in (g_eng, e_eng))
        else:
            got, want = (eng.decide_arrays(*fields, now) for eng in (g_eng, e_eng))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        assert g_eng.stats.snapshot() == e_eng.stats.snapshot(), step
        assert torch.equal(g_eng.store.data, e_eng.store.data), f"step {step}"
        if sk is not None:
            assert torch.equal(g_eng.sketch.data, e_eng.sketch.data), f"step {step}"
    torch.cuda.synchronize()
    stats = g_eng.stats.snapshot()
    assert stats["dropped"] > 0 and stats["evictions"] > 0
    chunks = g_eng.install_chunks + e_eng.install_chunks
    assert writeback_add.launches - before == 2 * stats["batches"] + chunks
    gr = g_eng.graphs
    assert gr.replays + gr.captures == stats["batches"]
    assert g_eng.graph_captures == (4 if program == "chain" else 0)
    assert g_eng.graph_count == pairs + g_eng.graph_captures
    reserved = torch.cuda.memory_reserved()
    g_eng.close()
    assert g_eng.graph_count == 0 and torch.cuda.memory_reserved() < reserved


def test_a_failing_capture_raises_on_card(monkeypatch):
    """A capture whose decide records other than one writeback launch, or
    that syncs the stream it captures, raises; the engine keeps no graph
    and does not fall back to the eager decide on the next batch of that
    shape. With the program restored the shape captures and replays."""
    _need_card()
    from gubernator_tpu_torch.core import graphs

    eng = TorchEngine(StoreConfig(rows=4, slots=64), buckets=(64,))
    kh = np.arange(1, 65, dtype=np.uint64) << np.uint64(32)
    one = np.ones(64, np.int64)
    args = (kh, one, one * 5, one * 60_000, np.zeros(64, np.int32), np.zeros(64, bool))
    real = graphs.PROGRAMS["exact"]

    def twice(*a):
        real(*a)
        return real(*a)

    def syncs(*a):
        out = real(*a)
        torch.cuda.current_stream().synchronize()
        return out

    monkeypatch.setitem(graphs.PROGRAMS, "exact", twice)
    for i in range(2):
        with pytest.raises(RuntimeError, match="recorded 2 writeback launches"):
            eng.decide_arrays(*args, 1_700_000_000_000 + i)
        assert eng.graph_count == 0
    monkeypatch.setitem(graphs.PROGRAMS, "exact", syncs)
    with pytest.raises(RuntimeError):
        eng.decide_arrays(*args, 1_700_000_000_002)
    assert eng.graph_count == 0
    monkeypatch.setitem(graphs.PROGRAMS, "exact", real)
    for i in range(2):
        eng.decide_arrays(*args, 1_700_000_000_003 + i)
    torch.cuda.synchronize()
    assert (eng.graph_count, eng.graphs.captures, eng.graphs.replays) == (1, 1, 1)


def test_a_capture_survives_the_rest_of_the_process_on_card(monkeypatch):
    """What other code of the process does while a decide is captured
    does not abort the capture: an older engine's graphs dropped by the
    collector inside the capture (retired, reset at the next safe
    point), the port's device-wide synchronize looping in another thread
    (it waits for the capture lock), and a second engine warming up
    (capturing) in a third thread (captures take turns, each recording
    its own one writeback launch). Each engine ends with every pair of
    its ladder captured and answers as the eager engine does."""
    import gc
    import threading

    _need_card()
    from gubernator_tpu_torch.core import graphs, kernels

    cfg = StoreConfig(rows=4, slots=64)
    now = 1_700_000_000_000
    old = TorchEngine(cfg, buckets=_GRAPH_LADDER)
    old.warmup(now=now)
    old.cycle = old  # freed by the collector only
    keep = [old]
    del old
    real = kernels.writeback_add
    collected = []

    def collect_inside_capture(*a):
        if torch.cuda.is_current_stream_capturing() and keep:
            keep.clear()
            collected.append(gc.collect())
        return real(*a)

    monkeypatch.setattr(kernels, "writeback_add", collect_inside_capture)
    stop, errors = threading.Event(), []

    def run(fn):
        try:
            fn()
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    def syncs():
        while not stop.is_set():
            graphs.synchronize()

    second = TorchEngine(cfg, buckets=_GRAPH_LADDER)
    threads = [threading.Thread(target=run, args=(syncs,)),
               threading.Thread(target=run, args=(lambda: second.warmup(now=now),))]
    for t in threads:
        t.start()
    eng = TorchEngine(cfg, buckets=_GRAPH_LADDER)
    try:
        run(lambda: eng.warmup(now=now))
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert errors == [] and collected and collected[0] > 0
    assert (eng.graph_count, second.graph_count) == (4, 4)
    ref = TorchEngine(cfg, buckets=_GRAPH_LADDER, cuda_graphs=False)
    ref.warmup(now=now)
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 2**64, 600, dtype=np.uint64)
    for step in range(8):
        fields = _graph_batch(rng, pool, step, False)
        got, want = (e.decide_arrays(*fields, now + step) for e in (eng, ref))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert eng.graph_captures == 0


def test_device_topk_on_card_matches_cpu():
    """DeviceTopK on the card against the CPU: the same table after each
    fold and decay (ties, hashes >= 2^63, zero weights, B < K), and its
    read-back waits for the table's own stream only, not for the decide
    batches queued on the current stream."""
    _need_card()
    from gubernator_tpu_torch.serve.promoter import OBSERVE_TOP, DeviceTopK

    gpu, cpu = DeviceTopK(64), DeviceTopK(64, device="cpu")
    assert gpu._kh.device.type == "cuda"
    rng = np.random.default_rng(10)
    pool = rng.integers(1, 2**64, 300, dtype=np.uint64)
    for step in range(12):
        n = int(rng.integers(1, OBSERVE_TOP + 1))
        kh = np.unique(pool[rng.integers(0, pool.shape[0], n)])
        w = rng.choice([0, 1, 1, 3, 9], kh.shape[0]).astype(np.int64)
        pay = {int(k): (int(k % 7), 1000) for k in kh}
        for t in (gpu, cpu):
            t.observe_arrays(kh, w, pay)
        if step % 4 == 3:
            for t in (gpu, cpu):
                t.decay()
        assert gpu.top_with_payload(64) == cpu.top_with_payload(64), step
        assert torch.equal(gpu._kh.cpu(), cpu._kh) and torch.equal(gpu._cnt.cpu(), cpu._cnt)
    torch.cuda._sleep(2_000_000_000)  # ~1 s of decide-stream work
    gpu.observe_arrays(pool[:4], np.ones(4, np.int64), {})
    gpu.top_with_payload(8)
    assert not torch.cuda.current_stream().query(), "the top-K read waited for the stream"
    torch.cuda.synchronize()


def test_server_on_card_walks_a_key_through_grpc():
    """A one-node port Server (the doors) on the card: a limit-2 key
    walks 1 -> 0 -> OVER_LIMIT with one reset_time through gRPC, every
    answer decided by batches that launched the writeback kernel, and the
    launches equal to the decides plus the engine's chunks; each decide
    also ran its six scans, and /v1/debug/stats reports both counts."""
    _need_card()
    import asyncio
    import json
    import socket
    from types import SimpleNamespace

    from gubernator_tpu_torch.api.types import RateLimitReq, Status
    from gubernator_tpu_torch.client import AsyncV1Client
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    conf = config_from_env({"GUBER_GRPC_ADDRESS": addr, "GUBER_STORE_MIB": "64",
                            "GUBER_DEVICE_BATCH_LIMIT": "1024"})

    async def run():
        server = Server(conf)
        await server.start()
        client = AsyncV1Client(addr)
        try:
            assert server.backend.device.type == "cuda"
            assert (await client.health_check(timeout=10)).status == "healthy"
            eng = server.backend.engine
            before, scans = writeback_add.launches, scan.seg_scan.launches
            counted = eng.stats.batches + eng.install_chunks + eng.gossip_chunks
            req = RateLimitReq(name="card", unique_key="walk", hits=1, limit=2,
                               duration=60_000)
            walk = [(await client.get_rate_limits([req], timeout=10))[0] for _ in range(3)]
            assert [r.remaining for r in walk] == [1, 0, 0]
            assert [r.status for r in walk] == [Status.UNDER_LIMIT, Status.UNDER_LIMIT,
                                                Status.OVER_LIMIT]
            assert len({r.reset_time for r in walk}) == 1 and not any(r.error for r in walk)
            if server.instance.promoter is not None:  # no tick between the reads
                await server.instance.promoter.stop()
            launched = writeback_add.launches - before
            counted = eng.stats.batches + eng.install_chunks + eng.gossip_chunks - counted
            assert launched >= 3 and launched == counted
            assert scan.seg_scan.launches - scans >= 6 * 3
            stats = json.loads((await server._http_debug_stats(SimpleNamespace(query={}))).text)
            assert stats["kernel_launches"] == {"writeback_add": writeback_add.launches,
                                                "seg_scan": scan.seg_scan.launches}
        finally:
            await client.close()
            await server.stop()

    asyncio.run(run())


@pytest.mark.parametrize("case", [dict(), dict(derivation="r13"), dict(algorithm="gcra")],
                         ids=["v2_token", "r13_token", "v2_gcra"])
def test_tail_error_on_card_matches_cpu(case):
    """cli/bench_serving.measure_tail_error on the card returns the dict
    the same call returns on the CPU: the sketch is integer state, so the
    errors are the same numbers; its writeback launches are its decides."""
    _need_card()
    from gubernator_tpu_torch.cli.bench_serving import measure_tail_error

    before = writeback_add.launches
    card = measure_tail_error(batches=16, device="cuda", **case)
    assert writeback_add.launches - before == 16 + 1  # the fillers' decide, then 16
    assert card == measure_tail_error(batches=16, device="cpu", **case)
    assert card["under_counts"] == 0 and card["within_bound"]


# -- the mesh policy: shards on the one card ----------------------------------------


def test_owner_of_on_card_matches_owner_of_np():
    """owner_of's unsigned remainder (32-bit halves of int64 bit patterns)
    on the card equals the numpy twin, hashes at and above 2^63 included."""
    _need_card()
    from gubernator_tpu_torch.parallel.sharded import owner_of, owner_of_np

    rng = np.random.default_rng(0x5EED)
    kh = rng.integers(0, 2**64 - 1, 1 << 16, dtype=np.uint64, endpoint=True)
    kh[: 1 << 15] |= np.uint64(1 << 63)
    kh[:4] = [1 << 63, 2**64 - 1, 0, (1 << 63) - 1]
    for n in (1, 2, 3, 4, 7, 8):
        got = owner_of(torch.from_numpy(kh.view(np.int64)).cuda(), n)
        np.testing.assert_array_equal(got.cpu().numpy(), owner_of_np(kh, n))


def _mesh_pair(n: int, sketch: bool):
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    kw = dict(buckets=(64, 256, 1024),
              sketch=SketchConfig(rows=2, width=1 << 12) if sketch else None)
    cfg = StoreConfig(rows=4, slots=1 << 10)
    return (MeshEngine(cfg, devices=["cuda:0"] * n, **kw),
            MeshEngine(cfg, devices=["cpu"] * n, **kw))


def test_four_shard_two_tier_mesh_on_card_matches_cpu():
    """Four shards of the two-tier engine on the one card decide, charge
    their sub-sketches and count byte for byte as on the CPU, with one
    writeback launch a shard a decide."""
    _need_card()
    card, cpu = _mesh_pair(4, sketch=True)
    rng = np.random.default_rng(21)
    pool = rng.integers(1, 2**63, 5000).astype(np.uint64)
    before = writeback_add.launches
    for step in range(8):
        n = int(rng.integers(200, 3000))
        args = (pool[rng.integers(0, 5000, n)], rng.integers(0, 3, n).astype(np.int64),
                np.full(n, 20, np.int64), np.full(n, 60_000, np.int64),
                rng.integers(0, 4, n).astype(np.int32), np.zeros(n, bool),
                1_700_000_000_000 + 10 * step)
        for x, y in zip(card.decide_arrays(*args), cpu.decide_arrays(*args)):
            np.testing.assert_array_equal(x, y)
    assert writeback_add.launches - before == 4 * 8
    np.testing.assert_array_equal(card.store_numpy(), cpu.store_numpy())
    np.testing.assert_array_equal(card.sketch_numpy(), cpu.sketch_numpy())
    assert card.stats.snapshot() == cpu.stats.snapshot()


_MESH_LADDER = (64, 256)  # sub-batch rungs 64, 96, 128, 192, 256


def _mesh_graph_batch(rng, pool, step: int, chain: bool, n_shards: int):
    """A batch that lands each step on another (B_sub, G_sub) pair of
    _MESH_LADDER's sub-batch ladder over `n_shards` shards, and on step
    21 on a rung past its top (chains: rows in chains of up to 3, a
    chain routed by its head)."""
    n = n_shards * ((40, 80, 150, 200)[step % 4] if step != 21 else 400)
    distinct = max(8, n // (1 + step % 3))
    keys = pool[rng.choice(pool.shape[0], min(distinct, pool.shape[0]), replace=False)]
    kh = keys[rng.integers(0, keys.shape[0], n)]
    fields = [kh, rng.choice([0, 1, 1, 2, 40], n), rng.choice([0, 3, 10, 1000], n),
              rng.choice([1, 1000, 60_000, (1 << 30) - 1], n),
              rng.integers(0, 4, n).astype(np.int32)]
    if chain:
        cid = np.arange(n) // 3
        return fields + [cid, kh[cid * 3]]
    return fields + [rng.random(n) < 0.05]


@pytest.mark.parametrize("program", ["exact", "sketch", "chain"])
def test_mesh_graph_replays_match_the_eager_mesh_on_card(program):
    """A graphed 4-shard mesh on cuda:0 (warmup captures every (B_sub,
    G_sub) pair of a small ladder, once a program; chains capture on
    first use) against the eager one (cuda_graphs=False) and a CPU mesh
    on the same batches, byte for byte: answers, stats, every shard's
    store and sub-sketch, with `now` advancing and, between batches, a
    reset, a load_state, a forced rebase, a GLOBAL sync and an
    install_windows (the graphs keep pointing at the live tensors), and
    one batch past the ladder's top (captured on first use, its staging
    slots grown). One device holds the 4 shards, so each batch is one
    replay that counts 4 writeback launches; close() hands the pool
    back."""
    _need_card()
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine, group_rungs

    sk = SketchConfig(rows=2, width=1 << 10) if program == "sketch" else None
    cfg = StoreConfig(rows=4, slots=64)  # small: drops and evictions
    mk = lambda dev, **kw: MeshEngine(cfg, devices=[dev] * 4, buckets=_MESH_LADDER,  # noqa: E731
                                      sketch=sk, **kw)
    g_eng, e_eng, c_eng = mk("cuda:0"), mk("cuda:0", cuda_graphs=False), mk("cpu")
    now = 1_700_000_000_000
    for eng in (g_eng, e_eng, c_eng):
        eng.warmup(now=now)
    pairs = sum(len(group_rungs(r)) for r in g_eng.sub_buckets) * (2 if sk else 1)
    assert (g_eng.graph_count, g_eng.graph_captures, e_eng.graph_count) == (pairs, 0, 0)
    assert len(g_eng.device_graphs) == 1 and g_eng.capture_s > 0
    assert g_eng.graph_pool_bytes > 0 and g_eng.warmup_launches == e_eng.warmup_launches
    rng = np.random.default_rng(31)
    pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    engines = (g_eng, e_eng, c_eng)
    before = writeback_add.launches
    saved = None
    for step in range(24):
        now += int(rng.choice([1, 50, 1000, 70_000]))
        if step == 6:
            saved = (c_eng.store_numpy(), c_eng.clock.epoch, c_eng.sketch_numpy())
        elif step == 9:
            for eng in engines:
                eng.reset()
        elif step == 12:
            for eng in engines:
                eng.load_state(*saved)
        elif step == 15:
            now += 1 << 30  # past the epoch's envelope: every shard rebases in place
        elif step == 18:
            kh, one = pool[:100], np.ones(100, np.int64)
            for eng in engines:
                eng.install_windows(kh, one * 9, one * 4, one * (now + 60_000),
                                    np.zeros(100, bool), now)
                eng.sync_globals(pool[100:164], np.full(64, 9, np.int64),
                                 np.full(64, 60_000, np.int64), now)
        fields = _mesh_graph_batch(rng, pool, step, program == "chain", 4)
        if program == "chain":
            outs = [eng.decide_chain_arrays(*fields, now) for eng in engines]
        else:
            outs = [eng.decide_arrays(*fields, now) for eng in engines]
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
        snaps = [eng.stats.snapshot() for eng in engines]
        assert snaps[0] == snaps[1] == snaps[2], step
        np.testing.assert_array_equal(g_eng.store_numpy(), e_eng.store_numpy(), f"step {step}")
        np.testing.assert_array_equal(g_eng.store_numpy(), c_eng.store_numpy(), f"step {step}")
        if sk is not None:
            np.testing.assert_array_equal(g_eng.sketch_numpy(), c_eng.sketch_numpy())
            np.testing.assert_array_equal(e_eng.sketch_numpy(), c_eng.sketch_numpy())
    torch.cuda.synchronize()
    stats = g_eng.stats.snapshot()
    assert stats["dropped"] > 0 and stats["evictions"] > 0
    chunks = sum(e.install_chunks + e.gossip_chunks for e in (g_eng, e_eng))
    assert writeback_add.launches - before == 4 * (2 * stats["batches"] + chunks)
    (gr,) = g_eng.device_graphs.values()
    assert gr.replays + gr.captures == stats["batches"]
    # the rung past the top, and the chain program's shapes: on first use
    assert g_eng.graph_captures > 1 if program == "chain" else g_eng.graph_captures == 1
    assert g_eng.graph_count == pairs + g_eng.graph_captures
    reserved = torch.cuda.memory_reserved()
    g_eng.close()
    assert g_eng.graph_count == 0 and torch.cuda.memory_reserved() < reserved


def test_a_failing_mesh_capture_raises_on_card(monkeypatch):
    """A mesh capture whose decides record other than one writeback launch
    a shard raises; the engine keeps no graph and does not fall back to
    the eager decide on the next batch of that shape. With the program
    restored the shape captures and replays."""
    _need_card()
    from gubernator_tpu_torch.core import graphs
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    eng = MeshEngine(StoreConfig(rows=4, slots=64), devices=["cuda:0"] * 4, buckets=(64,))
    kh = np.arange(1, 129, dtype=np.uint64) << np.uint64(32)
    one = np.ones(128, np.int64)
    args = (kh, one, one * 5, one * 60_000, np.zeros(128, np.int32), np.zeros(128, bool))
    real = graphs.PROGRAMS["exact"]

    def twice(*a):
        real(*a)
        return real(*a)

    monkeypatch.setitem(graphs.PROGRAMS, "exact", twice)
    for i in range(2):
        with pytest.raises(RuntimeError, match="recorded 8 writeback launches, not 4"):
            eng.decide_arrays(*args, 1_700_000_000_000 + i)
        assert eng.graph_count == 0
    monkeypatch.setitem(graphs.PROGRAMS, "exact", real)
    for i in range(2):
        eng.decide_arrays(*args, 1_700_000_000_002 + i)
    torch.cuda.synchronize()
    (gr,) = eng.device_graphs.values()
    assert (eng.graph_count, gr.captures, gr.replays) == (1, 1, 1)


@pytest.mark.parametrize("shards", [0, 4])  # 0: the flat engine
@pytest.mark.parametrize("sketch", [False, True])
def test_every_serving_rung_captured_cold_replays_the_eager_decide_on_card(shards, sketch):
    """Warmup runs a program eagerly only before its first capture on a
    device; every later (B, G) pair of the serving ladder
    (buckets_for_limit(32768): 20 flat pairs, 67 sub-batch pairs) is
    captured with no warm run of its own, so a kernel variant its sizes
    pick (the sorts' tiling, a larger grid) is first met inside the
    capture. Each such graph, replayed on a batch that lands on its
    pair, answers as the eager engine (cuda_graphs=False) does, with
    every program of the engine; at the end the stats, stores and
    sketches are identical, and no batch captured."""
    _need_card()
    from gubernator_tpu_torch.core.engine import buckets_for_limit, group_rungs
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine, owner_of_np

    ladder = buckets_for_limit(32768)
    cfg = StoreConfig(rows=4, slots=1 << 12)  # small: drops and evictions
    sk = SketchConfig(rows=2, width=1 << 12) if sketch else None
    if shards:
        mk = lambda **kw: MeshEngine(cfg, devices=["cuda:0"] * shards,  # noqa: E731
                                     buckets=ladder, sketch=sk, **kw)
    else:
        mk = lambda **kw: TorchEngine(cfg, buckets=ladder, sketch=sk, **kw)  # noqa: E731
    g_eng, e_eng = mk(), mk(cuda_graphs=False)
    now = 1_700_000_000_000
    for eng in (g_eng, e_eng):
        eng.warmup(now=now)
    rungs = g_eng.sub_buckets if shards else ladder
    tiers = (False, True) if sketch else (False,)
    pairs = [(r, g) for r in rungs for g in group_rungs(r)]
    (dg,) = g_eng.device_graphs.values() if shards else (g_eng.graphs,)
    assert (g_eng.graph_count, g_eng.graph_captures) == (len(pairs) * len(tiers), 0)
    # the decide programs run eagerly once each, before their first capture
    assert dg.warm & {"exact", "sketch", "chain"} == ({"exact", "sketch"} if sketch
                                                      else {"exact"})
    rng = np.random.default_rng(41)
    for step, (r, g) in enumerate(pairs):
        pool = rng.integers(1, 2**63, 8 * max(shards, 1) * g, np.int64).astype(np.uint64)
        if shards:
            owners = owner_of_np(pool, shards)
            kh = np.concatenate([np.resize(pool[owners == s][:g], r) for s in range(shards)])
        else:
            kh = np.resize(pool[:g], r)
        n = kh.shape[0]
        fields = (kh, rng.integers(1, 3, n).astype(np.int64),
                  rng.integers(1, 9, n).astype(np.int64),
                  rng.choice([1000, 60_000], n).astype(np.int64),
                  rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.05)
        for on in tiers:
            now += int(rng.choice([1, 50, 1000]))
            outs = []
            for eng in (g_eng, e_eng):
                eng.sketch_on = on
                outs.append(eng.decide_arrays(*fields, now))
            for a, b in zip(*outs):
                np.testing.assert_array_equal(a, b, err_msg=f"pair {(r, g)}, sketch_on {on}")
    torch.cuda.synchronize()
    snap = g_eng.stats.snapshot()
    assert snap == e_eng.stats.snapshot()
    assert snap["evictions"] + snap["dropped"] > 0
    np.testing.assert_array_equal(g_eng.store_numpy(), e_eng.store_numpy())
    if sketch:
        np.testing.assert_array_equal(g_eng.sketch_numpy(), e_eng.sketch_numpy())
    assert (g_eng.graph_captures, dg.replays) == (0, len(pairs) * len(tiers))
    g_eng.close()


def test_owner_masked_reads_on_card_match_the_flat_engine():
    """On the card, the mesh's owner-masked reads (snapshot_read,
    live_mask, sketch_estimates) and a GLOBAL sync answer as the flat
    engine's over the same traffic; a sync launches two writebacks a
    shard (the owner charge and the replica install)."""
    _need_card()
    from gubernator_tpu_torch.core.sketches import SketchConfig

    card, _cpu = _mesh_pair(4, sketch=True)
    flat = TorchEngine(StoreConfig(rows=4, slots=1 << 12), buckets=(64, 256, 1024),
                       device="cuda", sketch=SketchConfig(rows=2, width=1 << 12))
    rng = np.random.default_rng(5)
    kh = rng.integers(1, 2**63, 600).astype(np.uint64)
    n = kh.shape[0]
    args = (kh, np.ones(n, np.int64), np.full(n, 9, np.int64),
            np.full(n, 60_000, np.int64), np.zeros(n, np.int32), np.zeros(n, bool))
    now = 1_700_000_000_000
    for e in (card, flat):
        e.decide_arrays(*args, now)
    assert card.snapshot_read(kh, now + 1) == flat.snapshot_read(kh, now + 1)
    np.testing.assert_array_equal(card.live_mask(kh, now + 1), flat.live_mask(kh, now + 1))
    durs = np.full(n, 60_000, np.int64)
    np.testing.assert_array_equal(card.sketch_estimates(kh, durs, now + 1),
                                  flat.sketch_estimates(kh, durs, now + 1))
    before = writeback_add.launches
    a = card.apply_global_hits(kh[:100], np.ones(100, np.int64), np.full(100, 9, np.int64),
                               np.full(100, 60_000, np.int64), now + 2)
    assert writeback_add.launches - before == 2 * 4
    b = flat.apply_global_hits(kh[:100], np.ones(100, np.int64), np.full(100, 9, np.int64),
                               np.full(100, 60_000, np.int64), now + 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64))


# -- the installs, GLOBAL steps, reads and top-k fold as graphs --------------------


def _program_engines(shards: int, sketch: bool, ladder, slots: int = 64):
    """A graphed, an eager (cuda_graphs=False) and a CPU engine of one
    shape: flat (`shards` 0) or that many shards of cuda:0."""
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    cfg = StoreConfig(rows=4, slots=slots)  # small: drops and evictions
    sk = SketchConfig(rows=2, width=1 << 10) if sketch else None
    if shards:
        mk = lambda dev, **kw: MeshEngine(cfg, devices=[dev] * shards,  # noqa: E731
                                          buckets=ladder, sketch=sk, **kw)
    else:
        mk = lambda dev, **kw: TorchEngine(cfg, buckets=ladder, device=dev,  # noqa: E731
                                           sketch=sk, **kw)
    return mk("cuda:0"), mk("cuda:0", cuda_graphs=False), mk("cpu")


def _same_state(engines, what: str) -> None:
    g, e, c = engines
    for other in (e, c):
        np.testing.assert_array_equal(g.store_numpy(), other.store_numpy(), err_msg=what)
        if g.sketch is not None:
            np.testing.assert_array_equal(g.sketch_numpy(), other.sketch_numpy(),
                                          err_msg=what)
    assert g.stats.snapshot() == e.stats.snapshot() == c.stats.snapshot(), what


def _same_outs(outs, what: str) -> None:
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("shards", [0, 4])  # 0: the flat engine
@pytest.mark.parametrize("sketch", [False, True])
def test_program_graphs_match_the_eager_engine_and_the_cpu_on_card(shards, sketch):
    """The graphed engine's installs, GLOBAL steps and reads (warmup
    captures the token install and, on a mesh, the GLOBAL step at every
    rung, and with a sketch both reads at every READ_RUNGS rung) against
    the eager engine on the card and the CPU run, on the same calls
    between decides, byte for byte: apply_global_hits and sync_globals
    answers, update_globals, a full install_windows of an export (captured
    on first use), snapshot_read, live_mask and sketch_estimates (one
    read past the walked rungs: first use), promote_from_sketch; every
    shard's store and sketch and the stats after each. Launches balance
    with every install and GLOBAL step replayed, and no walked program
    captures after warmup."""
    _need_card()
    from gubernator_tpu_torch.core.engine import choose_bucket
    from gubernator_tpu_torch.parallel.sharded import READ_RUNGS

    ladder = _MESH_LADDER if shards else _GRAPH_LADDER
    engines = _program_engines(shards, sketch, ladder)
    g_eng, e_eng, c_eng = engines
    now = 1_700_000_000_000
    for eng in engines:
        eng.warmup(now=now)
    reads = 2 * len(READ_RUNGS) if sketch else 0
    assert g_eng.program_graph_count == len(ladder) * (2 if shards else 1) + reads
    assert (g_eng.program_captures, g_eng.first_use_captures) == (0, 0)
    assert g_eng.program_capture_s > 0 and e_eng.program_graph_count == 0
    rng = np.random.default_rng(51 + shards + sketch)
    pool = rng.integers(1, 2**64, 2000, dtype=np.uint64)
    n_local = max(shards, 1)
    before = writeback_add.launches
    first_use = set()  # the (program, rung)s the reference too compiles on first use
    for step in range(16):
        now += int(rng.choice([1, 50, 1000]))
        fields = _mesh_graph_batch(rng, pool, step % 4, False, n_local)
        _same_outs([eng.decide_arrays(*fields, now) for eng in engines], f"decide {step}")
        m = int(rng.integers(8, max(ladder) + 1))
        kh = pool[rng.choice(pool.shape[0], m, replace=False)]
        ones = np.ones(m, np.int64)
        op = step % 8
        what = f"step {step} op {op}"
        if op == 0:
            hits, algo = rng.integers(0, 4, m).astype(np.int64), rng.integers(0, 4, m)
            outs = [eng.apply_global_hits(kh, hits, ones * 7, ones * 60_000, now,
                                          algo=algo.astype(np.int32)) for eng in engines]
            _same_outs(outs, what)
        elif op == 1:
            for eng in engines:
                eng.sync_globals(kh, ones * 7, ones * 60_000, now)
        elif op == 2:
            for eng in engines:
                eng.update_globals(key_hash=kh, limit=ones * 9, remaining=ones * 3,
                                   reset_time=ones * (now + 30_000), is_over=kh % 3 == 0,
                                   now=now)
        elif op == 3:
            w = c_eng.export_windows(now)
            n = min(w["key_hash"].shape[0], max(ladder))
            assert n > 0
            first_use.add(("install_full", choose_bucket(ladder, n)))
            for eng in engines:
                eng.install_windows(*(w[k][:n] for k in ("key_hash", "limit", "remaining",
                                                          "reset_time", "is_over")),
                                    now=now, duration=w["duration"][:n], ts=w["ts"][:n],
                                    flags=w["flags"][:n])
        elif op in (4, 5):
            B = READ_RUNGS[step % len(READ_RUNGS)] if op == 4 else 2048
            rk = pool[rng.integers(0, pool.shape[0], B)]
            for rung in (B, 128):  # the snapshot_read below pads 100 keys to 128
                if not (sketch and rung in READ_RUNGS):
                    first_use.add(("rows", rung))
                    if sketch:
                        first_use.add(("sketch_min", rung))
            outs = [(eng.live_mask(rk, now), eng.sketch_estimates(rk, np.full(B, 60_000), now))
                    for eng in engines]
            _same_outs(outs, what)
            snaps = [eng.snapshot_read(rk[:100], now) for eng in engines]
            assert snaps[0] == snaps[1] == snaps[2], what
        elif sketch and op == 6:
            outs = [eng.promote_from_sketch(kh, ones * 3, ones * 60_000, now)
                    for eng in engines]
            _same_outs(outs, what)
        _same_state(engines, what)
    torch.cuda.synchronize()
    stats = g_eng.stats.snapshot()
    chunks = sum(e.install_chunks + e.gossip_chunks for e in (g_eng, e_eng))
    assert g_eng.install_chunks == e_eng.install_chunks > 0
    assert writeback_add.launches - before == n_local * (2 * stats["batches"] + chunks)
    assert g_eng.program_captures == 0 and g_eng.graph_captures == 0
    assert g_eng.first_use_captures == len(first_use), sorted(first_use)
    g_eng.close()
    assert g_eng.program_graph_count == 0


@pytest.mark.parametrize("shards", [0, 4])  # 0: the flat engine
def test_every_host_rung_program_captured_cold_replays_the_eager_one_on_card(shards):
    """Warmup runs each program eagerly only before its first capture on
    a device; its other rungs of the serving ladder (buckets_for_limit
    (32768)) are captured cold. Each such graph, replayed at its rung,
    installs (update_globals), charges and installs (apply_global_hits,
    sync_globals, on a mesh) and reads (live_mask, sketch_estimates,
    snapshot_read at every READ_RUNGS rung) as the eager engine does,
    store and sketch bytes after each; nothing captures."""
    _need_card()
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.parallel.sharded import READ_RUNGS

    ladder = buckets_for_limit(32768)
    g_eng, e_eng, _c = _program_engines(shards, True, ladder, slots=1 << 12)
    now = 1_700_000_000_000
    for eng in (g_eng, e_eng):
        eng.warmup(now=now)
    assert g_eng.program_graph_count == len(ladder) * (2 if shards else 1) + 2 * len(READ_RUNGS)
    rng = np.random.default_rng(61 + shards)
    pool = rng.integers(1, 2**64, 2 * max(ladder), dtype=np.uint64)
    for b in ladder:
        now += 7
        kh = pool[rng.choice(pool.shape[0], b, replace=False)]
        ones = np.ones(b, np.int64)
        fields = (kh, rng.integers(1, 3, b).astype(np.int64), ones * 5, ones * 60_000,
                  np.zeros(b, np.int32), np.zeros(b, bool))
        _same_outs([eng.decide_arrays(*fields, now) for eng in (g_eng, e_eng)], f"decide {b}")
        for eng in (g_eng, e_eng):
            eng.update_globals(key_hash=kh[::-1].copy(), limit=ones * 9, remaining=ones * 2,
                               reset_time=ones * (now + 9_000), is_over=kh % 2 == 0, now=now)
        if shards:
            _same_outs([eng.apply_global_hits(kh, ones, ones * 6, ones * 60_000, now)
                        for eng in (g_eng, e_eng)], f"ghits {b}")
            for eng in (g_eng, e_eng):
                eng.sync_globals(kh, ones * 6, ones * 60_000, now)
        np.testing.assert_array_equal(g_eng.store_numpy(), e_eng.store_numpy(), f"rung {b}")
        np.testing.assert_array_equal(g_eng.sketch_numpy(), e_eng.sketch_numpy(), f"rung {b}")
    for B in READ_RUNGS:
        rk = pool[rng.integers(0, pool.shape[0], B)]
        outs = [(eng.live_mask(rk, now), eng.sketch_estimates(rk, np.full(B, 60_000), now))
                for eng in (g_eng, e_eng)]
        _same_outs(outs, f"reads {B}")
        assert g_eng.snapshot_read(rk, now) == e_eng.snapshot_read(rk, now)
    assert (g_eng.program_captures, g_eng.first_use_captures, g_eng.graph_captures) == (0, 0, 0)
    assert g_eng.sketch_estimates(pool[:64], np.full(64, 60_000), now).any()
    g_eng.close()


def test_a_failing_program_capture_raises_on_card(monkeypatch):
    """An install or GLOBAL step whose capture records other than one
    writeback launch a shard a half, or a read that syncs the stream it
    captures, raises; the engine keeps no such graph and falls back to
    nothing. A read graph missing on a warmed engine raises. With the
    programs restored each shape captures and replays."""
    _need_card()
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel import sharded
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    cfg = StoreConfig(rows=4, slots=64)
    flat = TorchEngine(cfg, buckets=(64,), sketch=SketchConfig(rows=2, width=1 << 10))
    mesh = MeshEngine(cfg, devices=["cuda:0"] * 4, buckets=(64,))
    kh = np.arange(1, 65, dtype=np.uint64) << np.uint64(32)
    one = np.ones(64, np.int64)
    now = 1_700_000_000_000
    install = lambda eng: eng.update_globals(  # noqa: E731
        key_hash=kh, limit=one, remaining=one, reset_time=one * now,
        is_over=np.zeros(64, bool), now=now)
    ghits = lambda: mesh.apply_global_hits(kh, one, one * 5, one * 60_000, now)  # noqa: E731

    def twice(real):
        def fn(*a):
            real(*a)
            return real(*a)
        return fn

    def syncs(real):
        def fn(*a):
            out = real(*a)
            torch.cuda.current_stream().synchronize()
            return out
        return fn

    for name, call, err in (
        ("install_program", lambda: install(flat), "recorded 2 writeback launches, not 1"),
        ("install_program", lambda: install(mesh), "recorded 8 writeback launches, not 4"),
        ("sync_install_program", ghits, "recorded 12 writeback launches, not 8"),
    ):
        real = getattr(sharded, name)
        monkeypatch.setattr(sharded, name, twice(real))
        eng = mesh if call is ghits or "not 4" in err else flat
        before = eng.program_graph_count
        with pytest.raises(RuntimeError, match=err):
            call()
        assert eng.program_graph_count == before, name
        monkeypatch.setattr(sharded, name, real)
    real = sharded.rows_program
    monkeypatch.setattr(sharded, "rows_program", syncs(real))
    with pytest.raises(RuntimeError):
        flat.live_mask(kh, now)
    assert flat.program_graph_count == 0
    monkeypatch.setattr(sharded, "rows_program", real)
    for _ in range(2):  # each: a capture, then a replay
        for eng in (flat, mesh):
            install(eng)
        ghits()
        flat.live_mask(kh, now)
    torch.cuda.synchronize()
    (gr,) = mesh.device_graphs.values()
    assert (flat.program_graph_count, flat.graphs.program_replays) == (2, 2)
    assert (mesh.program_graph_count, gr.program_replays) == (2, 2)
    # a warmed engine must hold the reads its warmup walked
    flat.warmup(now=now)
    key = ("rows", 64, 0)
    flat.graphs.graphs.pop(key).graph.reset()
    with pytest.raises(RuntimeError, match="missing on a warmed engine"):
        flat.live_mask(kh, now)


def test_graphed_topk_fold_matches_the_eager_fold_and_the_cpu_on_card():
    """DeviceTopK folds through its graph (captured when it was built,
    replayed by every observe) as the eager fold on the card and the CPU
    fold do, fold for fold and across decays; nothing captures after the
    build."""
    _need_card()
    from gubernator_tpu_torch.serve.promoter import OBSERVE_TOP, DeviceTopK

    graphed = DeviceTopK(256)
    tables = (graphed, DeviceTopK(256, cuda_graphs=False), DeviceTopK(256, device="cpu"))
    assert graphed.graphs is not None and graphed.capture_s > 0
    assert tables[1].graphs is None and tables[2].graphs is None
    rng = np.random.default_rng(71)
    pool = rng.integers(1, 2**64, 600, dtype=np.uint64)
    for step in range(16):
        n = int(rng.integers(1, OBSERVE_TOP + 1))
        kh = np.unique(pool[rng.integers(0, pool.shape[0], n)])
        w = rng.choice([0, 1, 2, 5, 40], kh.shape[0]).astype(np.int64)
        for t in tables:
            t.observe_arrays(kh, w, {int(k): (5, 1000) for k in kh})
        if step % 5 == 4:
            for t in tables:
                t.decay()
        tops = [t.top_with_payload(256) for t in tables]
        assert tops[0] == tops[1] == tops[2], step
        for t in tables[1:]:
            assert torch.equal(graphed._kh.cpu(), t._kh.cpu()), step
            assert torch.equal(graphed._cnt.cpu(), t._cnt.cpu()), step
    assert graphed.graph_stats() == dict(graphed=True, captures=0, replays=16,
                                         capture_s=graphed.capture_s)


# -- the multi-process mesh: two processes sharing the card over gloo --------------


def test_two_processes_on_card_match_the_in_process_mesh(tmp_path):
    """Two processes of two shards each on cuda:0, joined over gloo: the
    runner's legs pass in the leader (decides, a sync, an upsert, two
    batches in flight, GLOBAL hits and promotes against the flat engine,
    the window ring), and its seeded script (decides, a sync, GLOBAL hit
    applies, a promote) answers, and leaves the store and sketch bytes
    (the processes' shards stacked), exactly as the in-process (2, 2)
    MeshEngine on the card."""
    _need_card()
    import _torch_multihost_runner as runner
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    runner.assert_ok(*runner.run_group(2, 2, "cuda:0", tmp_path, 300))
    eng = MeshEngine(StoreConfig(**runner.STORE), devices=["cuda:0"] * 4,
                     buckets=runner.BUCKETS, mesh_shape=(2, 2),
                     sketch=SketchConfig(**runner.SKETCH))
    eng._engine_now(runner.T0)
    want = runner.traffic_script(eng, 4)
    got, store, sketch = runner.load_outputs(tmp_path, 2)
    runner.assert_same_outputs(got, want)
    np.testing.assert_array_equal(store, eng.store_numpy())
    np.testing.assert_array_equal(sketch, eng.sketch_numpy())


def test_two_graphed_processes_on_card_match_the_in_process_mesh(tmp_path):
    """Two processes of four shards each on cuda:0, each deciding its
    shards as one graph replay a batch: the lockstep warmup captures the
    same shapes in both (graph_captures 0 after it), while in each
    process a side thread keeps capturing a flat engine's warmup, which
    survives that process's replays, gathers, all_reduces and syncs and
    the other process's; then the seeded script answers, and leaves the
    store and sketch bytes, exactly as the eager in-process (2, 4) mesh
    on the card."""
    _need_card()
    import _torch_multihost_runner as runner
    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.parallel.sharded import MeshEngine

    l_rc, l_out, f_rcs, f_outs = runner.run_group(
        2, 4, "cuda:0", tmp_path, 400, leader_role="leader-graphs",
        follower_role="follower-graphs")
    assert l_rc == 0 and "LEADER-GRAPHS-OK" in l_out, (
        f"leader failed:\n{l_out}\nfollower:\n" + "\n".join(f_outs))
    assert f_rcs == [0] and "FOLLOWER-GRAPHS-OK" in f_outs[0], f_outs[0]
    eng = MeshEngine(StoreConfig(**runner.STORE), devices=["cuda:0"] * 8,
                     buckets=runner.BUCKETS, mesh_shape=(2, 4),
                     sketch=SketchConfig(**runner.SKETCH), cuda_graphs=False)
    eng._engine_now(runner.T0)
    want = runner.traffic_script(eng, 8)
    got, store, sketch = runner.load_outputs(tmp_path, 2)
    runner.assert_same_outputs(got, want)
    np.testing.assert_array_equal(store, eng.store_numpy())
    np.testing.assert_array_equal(sketch, eng.sketch_numpy())


def test_mismatched_follower_is_nacked_on_card(tmp_path):
    """A follower on the card built with another ladder: the hello is
    nacked and both processes fail loudly with the diagnostic."""
    _need_card()
    import _torch_multihost_runner as runner

    runner.assert_mismatch_ok(*runner.run_group(
        2, 1, "cuda:0", tmp_path, 120, leader_role="leader-mismatch",
        follower_role="follower-mismatch",
    ))
