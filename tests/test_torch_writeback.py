"""The port's store writeback and its scan helpers against the JAX
package.

`writeback_add_plain` (the plain version the CPU path and the card's
check use) is held bit for bit against the TPU kernel it stands in for,
gubernator_tpu.core.pallas_sweep._apply_inline run in interpret mode,
and against the XLA scatter-add, on the way-disjoint recipe of
tests/test_kernels.py::test_pallas_sweep_matches_scatter with values
spanning all of int32 (so the adds wrap). Tolerance: zero.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py
holds it against the plain version there.
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
    writeback_add,
    writeback_add_plain,
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
