"""The port's segmented scans (core/scan.py) against the JAX package.

The plain versions, which CPU tensors take, are held bit for bit
against the JAX package's `_seg_scan` (a saturating add under
`lax.associative_scan`) and `_segment_ends` (its reverse min-scan), the
row prefix against jnp.cumsum along the rows, and the segment starts
against a running maximum of the leader positions,
at the edges: one row, every row a leader, one segment over all rows
(whose sums saturate at 2^31-1), random and zipf-like runs, and no
leader at row 0. The wrappers' contract: CPU tensors run the plain
version and count no launch; what the kernel does not take (dtypes,
shapes, devices) raises before anything runs, on the CPU as on the card.

The CUDA kernel runs only on a GPU: tests/test_torch_cuda.py holds it
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.core import kernels as jk
from gubernator_tpu_torch.core import scan
from _torch_cases import SCAN_PATTERNS, scan_case  # tests/, on the path under pytest

_N = (1, 7, 300)


@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("k", [1, 2, 17])
@pytest.mark.parametrize("n", _N)
def test_seg_scan_matches_the_jax_saturating_scan(n, k, pattern):
    lead, vals = scan_case(pattern, n, k)
    want = np.asarray(jax.jit(jk._seg_scan)(jnp.asarray(lead), jnp.asarray(vals)))
    before = scan.seg_scan.launches
    got = scan.seg_scan(torch.from_numpy(lead), torch.from_numpy(vals))
    assert scan.seg_scan.launches == before  # the plain version ran
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if pattern == "one_segment" and n == 300:
        assert (want == 2**31 - 1).any()  # the saturation engaged


@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("n", _N)
def test_segment_ends_match_the_jax_reverse_min_scan(n, pattern):
    lead, _ = scan_case(pattern, n, 1)
    want = np.asarray(jk._segment_ends(jnp.asarray(lead), jnp.arange(n, dtype=jnp.int32)))
    got = scan.segment_ends(torch.from_numpy(lead))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
@pytest.mark.parametrize("n", _N)
def test_leader_pos_is_the_running_max_of_leader_positions(n, pattern):
    lead, _ = scan_case(pattern, n, 1)
    want = np.maximum.accumulate(np.where(lead, np.arange(n), 0))
    got = scan.leader_pos(torch.from_numpy(lead))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_no_leader_at_row_zero_continues_from_row_zero():
    """Rows before the first flag form the first segment: their sums run
    from row 0, their start is 0, their end the row before the flag."""
    lead = np.array([False, False, True, False], bool)
    vals = np.array([[1], [2], [3], [4]], np.int32)
    t = torch.from_numpy(lead)
    assert scan.seg_scan(t, torch.from_numpy(vals)).flatten().tolist() == [1, 3, 3, 7]
    assert scan.leader_pos(t).tolist() == [0, 0, 2, 2]
    assert scan.segment_ends(t).tolist() == [1, 1, 3, 3]


def test_empty_input_gives_empty_output():
    lead = torch.zeros(0, dtype=torch.bool)
    assert scan.seg_scan(lead, torch.zeros((0, 3), dtype=torch.int32)).shape == (0, 3)
    assert scan.segment_ends(lead).shape == (0,)
    assert scan.leader_pos(lead).shape == (0,)


_LEAD = torch.ones(8, dtype=torch.bool)
_VALS = torch.ones((8, 2), dtype=torch.int32)


@pytest.mark.parametrize(
    "lead, vals, exc",
    [
        (_LEAD.to(torch.uint8), _VALS, TypeError),  # flags not bool
        (_LEAD, _VALS.to(torch.int64), TypeError),  # values not int32
        (_LEAD, _VALS.flatten(), ValueError),  # values not [N, K]
        (_LEAD, torch.ones((8, 0), dtype=torch.int32), ValueError),  # K = 0
        (_LEAD, torch.ones((8, 18), dtype=torch.int32), ValueError),  # K past 17
        (_LEAD, torch.ones((7, 2), dtype=torch.int32), ValueError),  # N differs
        (_LEAD, torch.ones((2, 8), dtype=torch.int32).t(), ValueError),  # not contiguous
        (torch.ones(16, dtype=torch.bool)[::2], _VALS, ValueError),  # flags strided
        (torch.ones((8, 1), dtype=torch.bool), _VALS, ValueError),  # flags not [N]
        (torch.ones(8, dtype=torch.bool, device="meta"),
         torch.ones((8, 2), dtype=torch.int32, device="meta"), ValueError),  # device
        (_LEAD, torch.ones((8, 2), dtype=torch.int32, device="meta"), ValueError),  # mixed
    ],
)
def test_seg_scan_refuses_what_the_kernel_does_not_take(lead, vals, exc):
    before = (scan.seg_scan.launches, scan.seg_scan.captured)
    with pytest.raises(exc):
        scan.seg_scan(lead, vals)
    assert (scan.seg_scan.launches, scan.seg_scan.captured) == before


@pytest.mark.parametrize("fn", [scan.segment_ends, scan.leader_pos])
@pytest.mark.parametrize(
    "lead, exc",
    [
        (torch.ones(8, dtype=torch.int32), TypeError),
        (torch.ones((2, 4), dtype=torch.bool), ValueError),
        (torch.ones(8, dtype=torch.bool, device="meta"), ValueError),
    ],
)
def test_segment_bounds_refuse_what_the_kernel_does_not_take(fn, lead, exc):
    with pytest.raises(exc):
        fn(lead)


@pytest.mark.parametrize("shape", [(1, 1), (7, 16), (300, 5)])
def test_row_cumsum_matches_jnp_cumsum_along_rows(shape):
    """The writeback plan's empty-way ranks (jnp.cumsum along axis 1 of
    0/1 ways), and, past 2^31-1, the saturating sum the kernel gives."""
    rng = np.random.default_rng(shape)
    ways = (rng.random(shape) < 0.4).astype(np.int32)
    want = np.asarray(jnp.cumsum(jnp.asarray(ways), axis=1))
    np.testing.assert_array_equal(scan.row_cumsum(torch.from_numpy(ways)).numpy(), want)
    big = rng.integers(2**30, 2**31 - 1, shape, dtype=np.int64)
    got = scan.row_cumsum(torch.from_numpy(big.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.minimum(np.cumsum(big, axis=1), 2**31 - 1))


@pytest.mark.parametrize(
    "x, exc",
    [
        (torch.ones((4, 3), dtype=torch.int64), TypeError),
        (torch.ones(12, dtype=torch.int32), ValueError),
        (torch.ones((3, 4), dtype=torch.int32).t(), ValueError),
        (torch.ones((4, 3), dtype=torch.int32, device="meta"), ValueError),
    ],
)
def test_row_cumsum_refuses_what_the_kernel_does_not_take(x, exc):
    with pytest.raises(exc):
        scan.row_cumsum(x)


def test_count_replay_adds_a_replays_recorded_scans(monkeypatch):
    monkeypatch.setattr(scan.seg_scan, "launches", 7)
    scan.count_replay(5)
    assert scan.seg_scan.launches == 12
