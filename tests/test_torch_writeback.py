"""The port's store writeback and its scan helpers against the JAX
package.

`writeback_add_plain` (the plain version the CPU path and the card's
check use) is held bit for bit against the TPU kernel it stands in for,
gubernator_tpu.core.pallas_sweep._apply_inline run in interpret mode,
and against the XLA scatter-add, on the way-disjoint recipe of
tests/test_kernels.py::test_pallas_sweep_matches_scatter with values
spanning all of int32 (so the adds wrap). Tolerance: zero.

`add_one_plain`, the copy floor's plain version, is held against the
identity sweep of scripts/bench_hbm.py (`kern` inside `ident`: out =
data + 1 in row tiles), rebuilt here as the same pallas_call and run in
interpret mode.

The writeback ablation's plain versions (the port of
scripts/ablate_sweep.py's kernel: `rows`, `deltas`, and `full` at each
chunk height) are held against numpy, and `full` against the Pallas
sweep in interpret mode.

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against the plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import kernels as jk
from gubernator_tpu.core import pallas_sweep as ps
from gubernator_tpu_torch.core import kernels as tk
from gubernator_tpu_torch.core.writeback import (
    ABLATION_ROWS,
    add_one,
    add_one_plain,
    run_ends,
    writeback_add,
    writeback_add_plain,
    writeback_deltas,
    writeback_deltas_plain,
    writeback_full,
    writeback_rows,
    writeback_rows_plain,
)


def _recipe(seed: int, buckets: int, B: int, W: int = 128):
    """Random store, sorted buckets, way-disjoint delta rows (each
    duplicate run takes a distinct 8-lane way), values over all of
    int32."""
    rng = np.random.default_rng(seed)
    ways = W // 8
    data = rng.integers(-(2**31), 2**31 - 1, (buckets, W), dtype=np.int64
                        ).astype(np.int32)
    bkt = np.sort(rng.integers(0, buckets, B)).astype(np.int32)
    drow = np.zeros((B, W), np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, (B, 8), dtype=np.int64
                        ).astype(np.int32)
    run = 0
    for i in range(B):
        run = run + 1 if i and bkt[i] == bkt[i - 1] else 0
        w = run % ways
        if rng.random() < 0.7:
            drow[i, w * 8 : (w + 1) * 8] = vals[i]
    return data, bkt, drow


def _plain(data, bkt, drow) -> np.ndarray:
    d = torch.from_numpy(data.copy())
    out = writeback_add_plain(d, torch.from_numpy(bkt), torch.from_numpy(drow))
    assert out.data_ptr() == d.data_ptr()  # in place
    return out.numpy()


def test_plain_matches_pallas_sweep_interpret():
    data, bkt, drow = _recipe(11, 256, 512)
    want = np.asarray(
        ps._apply_inline(
            jnp.asarray(data), jnp.asarray(bkt), jnp.asarray(drow),
            interpret=True,
        )
    )
    np.testing.assert_array_equal(_plain(data, bkt, drow), want)


@pytest.mark.parametrize("W", [8, 32, 128])
def test_plain_matches_xla_scatter_add(W):
    data, bkt, drow = _recipe(W, 64, 700, W)
    want = np.asarray(
        jnp.asarray(data).at[jnp.asarray(bkt)].add(
            jnp.asarray(drow), indices_are_sorted=True
        )
    )
    got = _plain(data, bkt, drow)
    np.testing.assert_array_equal(got, want)
    # the adds really wrapped somewhere (values span int32)
    wide = data.astype(np.int64)
    np.add.at(wide, bkt, drow.astype(np.int64))
    assert (wide != got).any()


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    data, bkt, drow = _recipe(3, 32, 100, 64)
    before = writeback_add.launches
    d = torch.from_numpy(data.copy())
    writeback_add(d, torch.from_numpy(bkt), torch.from_numpy(drow))
    assert writeback_add.launches == before
    np.testing.assert_array_equal(d.numpy(), _plain(data, bkt, drow))


@pytest.mark.parametrize(
    "mutate, exc",
    [
        (lambda d, b, r: (d.to(torch.int64), b, r), TypeError),
        (lambda d, b, r: (d, b.to(torch.int64), r), TypeError),
        (lambda d, b, r: (d, b, r[:, :64].contiguous()), ValueError),
        (lambda d, b, r: (d, b, r.t().contiguous().t()), ValueError),
        (lambda d, b, r: (d[:, :24].contiguous(), b, r[:, :24].contiguous()),
         ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, exc):
    data, bkt, drow = _recipe(4, 16, 32)
    d, b, r = mutate(
        torch.from_numpy(data), torch.from_numpy(bkt), torch.from_numpy(drow)
    )
    with pytest.raises(exc):
        writeback_add(d, b, r)


def _pallas_ident(x, tile):
    """scripts/bench_hbm.py's identity sweep (its `ident(tile)`), in
    interpret mode."""
    from jax.experimental import pallas as pl

    def kern(data_ref, out_ref):
        out_ref[:] = data_ref[:] + 1

    rows = x.shape[0]
    with jax.enable_x64(False):
        return pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
            grid=(rows // tile,),
            in_specs=[pl.BlockSpec((tile, 128), lambda t: (t, 0))],
            out_specs=pl.BlockSpec((tile, 128), lambda t: (t, 0)),
            input_output_aliases={0: 0},
            interpret=True,
        )(x)


@pytest.mark.parametrize("tile", [128, 512])
def test_copy_floor_plain_matches_pallas_identity_sweep(tile):
    rng = np.random.default_rng(tile)
    data = rng.integers(-(2**31), 2**31 - 1, (1024, 128), dtype=np.int64).astype(np.int32)
    data[0, 0] = 2**31 - 1  # wraps
    want = np.asarray(_pallas_ident(jnp.asarray(data), tile))
    x = torch.from_numpy(data.copy())
    before = add_one.launches
    got = add_one(x)  # a CPU tensor: the plain version, no launch
    assert add_one.launches == before and got.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(add_one_plain(torch.from_numpy(data.copy())).numpy(), want)
    assert want[0, 0] == -(2**31)


@pytest.mark.parametrize("bad, exc", [
    (torch.zeros(8, dtype=torch.int64), TypeError),
    (torch.zeros(8, 8, dtype=torch.int32).t(), ValueError),
])
def test_copy_floor_rejects_bad_inputs(bad, exc):
    with pytest.raises(exc):
        add_one(bad)


def _seg_inputs(seed: int, B: int, big: bool):
    rng = np.random.default_rng(seed)
    is_leader = rng.random(B) < 0.3
    is_leader[0] = True
    hi = 2**31 - 1 if big else 50
    values = rng.integers(0, hi, (B, 2), dtype=np.int64).astype(np.int32)
    values[rng.random(B) < 0.3] = 0
    return is_leader, values


@pytest.mark.parametrize("seed, big", [(0, False), (1, True), (2, True)])
def test_seg_scan_equals_saturating_associative_scan(seed, big):
    is_leader, values = _seg_inputs(seed, 1024, big)
    want = np.asarray(
        jax.jit(jk._seg_scan)(jnp.asarray(is_leader), jnp.asarray(values))
    )
    got = tk._seg_scan(torch.from_numpy(is_leader), torch.from_numpy(values))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if big:
        assert (want == 2**31 - 1).any()  # the saturation engaged


def test_segment_ends_matches_reverse_min_scan():
    is_leader, _ = _seg_inputs(5, 777, False)
    ar = jnp.arange(777, dtype=jnp.int32)
    want = np.asarray(jk._segment_ends(jnp.asarray(is_leader), ar))
    got = tk._segment_ends(torch.from_numpy(is_leader)).numpy()
    np.testing.assert_array_equal(got, want)


def test_first_index_ties_match_jnp_argmax_argmin():
    rng = np.random.default_rng(8)
    m = rng.random((512, 16)) < 0.2
    m[:40] = False  # no match at all -> 0, like jnp.argmax
    m[40:80] = True
    np.testing.assert_array_equal(
        tk._first_true(torch.from_numpy(m)).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(m), axis=1)),
    )
    k = rng.integers(-3, 3, (512, 16)).astype(np.int32)  # many ties
    k[:30] = -(2**31)  # all-empty buckets tie at I32_MIN
    np.testing.assert_array_equal(
        tk._argmin_first(torch.from_numpy(k)).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(k), axis=1)),
    )


# -- the writeback ablation (scripts/ablate_sweep.py's kernel) ----------------


def _ablation_inputs(seed: int, buckets: int = 512, G: int = 700, W: int = 128):
    """The script's recipe at a small size: a random store, sorted bucket
    ids with duplicate runs, delta rows over all of int32 (30% zero)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-(2**31), 2**31 - 1, (buckets, W), dtype=np.int64).astype(np.int32)
    bkt = np.sort(rng.integers(0, buckets // 4, G)).astype(np.int32)
    drow = rng.integers(-(2**31), 2**31 - 1, (G, W), dtype=np.int64).astype(np.int32)
    drow[rng.random(G) < 0.3] = 0
    return data, bkt, drow


def _deltas_numpy(bkt, drow, krows):
    """Each run of equal buckets within a chunk of krows rows, summed in
    int64 and wrapped to int32, at the run's last row; zeros elsewhere."""
    out = np.zeros(drow.shape, np.int64)
    G = bkt.shape[0]
    start = 0
    for i in range(G):
        last = i == G - 1 or bkt[i + 1] != bkt[i] or (i + 1) % krows == 0
        if last:
            out[i] = drow[start:i + 1].astype(np.int64).sum(axis=0)
            start = i + 1
    return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)


def test_ablation_rows_plain_adds_one_to_each_touched_row_once():
    """`rows` stores each touched row back plus one, once a bucket however
    long its run (with int32 wrap), and leaves every other row alone."""
    data, bkt, _ = _ablation_inputs(1)
    data[bkt[0]] = 2**31 - 1
    assert (np.diff(bkt) == 0).any()  # some bucket repeats
    want = data.astype(np.int64)
    want[np.unique(bkt)] += 1
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    d = torch.from_numpy(data.copy())
    before = writeback_rows.launches
    assert writeback_rows(d, torch.from_numpy(bkt)).data_ptr() == d.data_ptr()
    assert writeback_rows.launches == before  # a CPU tensor: the plain version
    np.testing.assert_array_equal(d.numpy(), want)
    np.testing.assert_array_equal(
        writeback_rows_plain(torch.from_numpy(data.copy()), torch.from_numpy(bkt)).numpy(),
        want)


@pytest.mark.parametrize("krows", ABLATION_ROWS)
def test_ablation_deltas_plain_matches_numpy(krows):
    _, bkt, drow = _ablation_inputs(krows)
    want = _deltas_numpy(bkt, drow, krows)
    out = torch.zeros(drow.shape, dtype=torch.int32)
    before = writeback_deltas.launches
    got = writeback_deltas(out, torch.from_numpy(bkt), torch.from_numpy(drow), krows)
    assert writeback_deltas.launches == before and got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)
    plain = writeback_deltas_plain(torch.zeros(drow.shape, dtype=torch.int32),
                                   torch.from_numpy(bkt), torch.from_numpy(drow), krows)
    np.testing.assert_array_equal(plain.numpy(), want)
    # the runs really were cut at chunk edges and summed with wrap
    ends = run_ends(torch.from_numpy(bkt), krows).numpy()
    rows = np.arange(len(bkt))
    assert (ends >= rows).all() and (ends // krows == rows // krows).all()
    wide = np.zeros(drow.shape, np.int64)
    np.add.at(wide, ends, drow.astype(np.int64))
    assert (wide != want).any()


@pytest.mark.parametrize("krows", ABLATION_ROWS)
def test_ablation_full_plain_matches_pallas_sweep_interpret(krows):
    """`full` at every chunk height is writeback_add's function, that of the
    TPU kernel: held against gubernator_tpu.core.pallas_sweep run in
    interpret mode (as the JAX tests run it on the CPU) and against
    numpy's wrapped add."""
    data, bkt, drow = _recipe(20 + krows, 256, 512)
    want = np.asarray(ps._apply_inline(jnp.asarray(data), jnp.asarray(bkt),
                                       jnp.asarray(drow), interpret=True))
    d = torch.from_numpy(data.copy())
    before = writeback_full.launches, writeback_add.launches
    writeback_full(d, torch.from_numpy(bkt), torch.from_numpy(drow), krows)
    assert (writeback_full.launches, writeback_add.launches) == before
    np.testing.assert_array_equal(d.numpy(), want)
    wide = data.astype(np.int64)
    np.add.at(wide, bkt, drow.astype(np.int64))
    np.testing.assert_array_equal(((wide + 2**31) % 2**32 - 2**31).astype(np.int32), want)


@pytest.mark.parametrize("call", [
    lambda d, b, r: writeback_full(d, b, r, krows=32),
    lambda d, b, r: writeback_rows(d, b, krows=2),
    lambda d, b, r: writeback_deltas(torch.zeros_like(r), b, r, krows=12),
    lambda d, b, r: writeback_deltas(torch.zeros(3, 128, dtype=torch.int32), b, r),
    lambda d, b, r: writeback_rows(d, b.to(torch.int64)),
])
def test_ablation_wrappers_reject_bad_inputs(call):
    data, bkt, drow = (torch.from_numpy(x) for x in _ablation_inputs(2, G=40))
    with pytest.raises((ValueError, TypeError)):
        call(data, bkt, drow)


def test_ablation_cli_inputs_and_bytes_on_the_cpu(capsys):
    """cli/ablate_writeback.py draws the script's inputs (seed 5: 16,384
    sorted ids over 32,768 buckets) and counts each step's bytes from the
    batch's own runs; with no card it exits 1 and says why."""
    from gubernator_tpu_torch.cli import ablate_writeback as aw

    _name, data, [(bkt, drow)], in_l2 = aw.script_shape("cpu")
    assert in_l2  # 16 MiB: the bound at this shape is left out
    assert tuple(data.shape) == (32768, 128) and bkt.shape == (16384,)
    assert (np.diff(bkt) >= 0).all() and drow.shape == (16384, 128)
    assert drow.min() >= -1000 and drow.max() < 1000  # the script's delta range
    b = torch.from_numpy(bkt)
    G, U = bkt.shape[0], np.unique(bkt).shape[0]
    assert aw.step_bytes("rows", b, 8) == 2 * U * 512 + G * 4
    assert aw.step_bytes("full", b, 8) == G * 512 + G * 4 + 2 * U * 512
    chunk_runs = np.unique(run_ends(b, 8).numpy()).shape[0]
    assert U <= chunk_runs <= U + G // 8
    assert aw.step_bytes("deltas", b, 8) == G * 512 + G * 4 + chunk_runs * 512
    _name, small, sets, in_l2 = aw.two_tier_shape("cpu", sets=2, depth=2048, buckets=1 << 12)
    assert not in_l2
    assert tuple(small.shape) == (4096, 128) and len(sets) == 2
    for bk, dr in sets:  # the decide's padded group stream: sorted, in range
        assert (np.diff(bk) >= 0).all() and bk.min() >= 0 and bk.max() < 4096
        assert dr.shape == (bk.shape[0], 128)
    if not torch.cuda.is_available():
        assert aw.main([]) == 1
        assert "needs a CUDA device" in capsys.readouterr().err
