"""Segmented scans of the decide: the port's counterpart of the JAX
package's `lax.associative_scan` calls (gubernator_tpu/core/kernels.py
`_seg_scan`, :244-260, and `_segment_ends`, :264-269).

Rows are cut into contiguous segments by a leader flag (bool[N]): one
segment starts at every flagged row, and the first at row 0 whether it
is flagged or not.

- `seg_scan(is_leader, values)`: each column's segmented inclusive
  prefix sum of non-negative int32 values [N, K], 1 <= K <= 17,
  saturating at 2^31-1 (the JAX package's saturating add; for
  non-negative inputs that is min(plain segment sum, 2^31-1));
- `leader_pos(is_leader)`: int32[N], each row's segment start (0 before
  the first flag);
- `segment_ends(is_leader)`: int32[N], each row's inclusive segment end
  (the row before the next flag, N-1 for the final segment);
- `row_cumsum(x)`: each row's inclusive prefix sum across the columns
  of non-negative int32 x [G, W], saturating at 2^31-1: the same scan
  over x's G * W elements in order, a segment a row.

On a CUDA tensor each launches the hand-written kernel in
csrc/segscan.cu (its source note says what bounds it and how it is
designed), built by core.writeback.build() into the port's one library,
on the current stream; a refused launch raises. On a CPU tensor each
runs its plain PyTorch version (`*_plain`), which the CPU tests hold
against the JAX package. There is no fallback between the two.

Every launch counts in `seg_scan.launches` (one a call, whichever of the
four functions made it, although a call of more than one tile runs a
totals grid before its scan grid). Under a CUDA graph capture the call
is only recorded, so it counts in `seg_scan.captured` instead, and each
replay of the graph adds its recorded calls to `launches`
(count_replay, core/graphs.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from gubernator_tpu_torch.core import writeback

I32_MAX = (1 << 31) - 1
#: the widest `values` the kernel scans (the writeback plan's 1 + ways)
MAX_COLUMNS = 17

_MODE_SUM, _MODE_START, _MODE_END = 0, 1, 2


def leader_pos_plain(is_leader: torch.Tensor) -> torch.Tensor:
    """The plain version: a cumulative max of the leader positions."""
    ar = torch.arange(is_leader.shape[0], dtype=torch.int64, device=is_leader.device)
    return torch.cummax(torch.where(is_leader, ar, 0), dim=0).values.to(torch.int32)


def seg_scan_plain(is_leader: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The plain version: an int64 cumsum minus each segment's exclusive
    start, clamped at 2^31-1 (exact for non-negative values: N * 2^31 <
    2^63)."""
    c = torch.cumsum(values.to(torch.int64), dim=0)
    start_excl = (c - values)[leader_pos_plain(is_leader)]
    return torch.clamp_max(c - start_excl, I32_MAX).to(torch.int32)


def row_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: an int64 cumsum along each row, clamped at
    2^31-1."""
    return torch.clamp_max(torch.cumsum(x.to(torch.int64), dim=1), I32_MAX).to(torch.int32)


def segment_ends_plain(is_leader: torch.Tensor) -> torch.Tensor:
    """The plain version: the reverse min-scan of the leader positions as
    flip + cummin + flip, shifted by one (empty for no rows)."""
    B = is_leader.shape[0]
    ar = torch.arange(B, dtype=torch.int32, device=is_leader.device)
    lead_idx = torch.where(is_leader, ar, B)
    next_incl = torch.flip(torch.cummin(torch.flip(lead_idx, [0]), dim=0).values, [0])
    return (torch.cat([next_incl[1:], next_incl.new_full((1,), B)]) - 1)[:B]


def _check(name: str, is_leader: torch.Tensor, values: Optional[torch.Tensor]) -> str:
    """Device, dtype, contiguity and shapes; returns the device type."""
    if is_leader.dtype != torch.bool:
        raise TypeError(f"{name}: is_leader must be bool, got {is_leader.dtype}")
    if is_leader.dim() != 1 or not is_leader.is_contiguous():
        raise ValueError(f"{name}: is_leader must be a contiguous [N] tensor")
    if values is not None:
        if values.dtype != torch.int32:
            raise TypeError(f"{name}: values must be int32, got {values.dtype}")
        if values.device != is_leader.device:
            raise ValueError(
                f"{name}: is_leader on {is_leader.device}, values on {values.device}"
            )
        if (values.dim() != 2 or values.shape[0] != is_leader.shape[0]
                or not 1 <= values.shape[1] <= MAX_COLUMNS):
            raise ValueError(
                f"{name}: values {tuple(values.shape)} is not [{is_leader.shape[0]}, K] "
                f"with 1 <= K <= {MAX_COLUMNS}"
            )
        if not values.is_contiguous():
            raise ValueError(f"{name}: values must be contiguous")
    if is_leader.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {is_leader.device}")
    return is_leader.device.type


def _launch(name: str, is_leader: Optional[torch.Tensor], values: Optional[torch.Tensor],
            mode: int, width: int = 0) -> torch.Tensor:
    """One scan on the current stream into a new int32 tensor: segments
    at the rows `is_leader` flags, or (is_leader None) every `width`
    rows of the [N, 1] `values`."""
    like = values if is_leader is None else is_leader
    n = like.shape[0]
    k = 1 if values is None else values.shape[1]
    shape = (n,) if values is None else (n, k)
    out = torch.empty(shape, dtype=torch.int32, device=like.device)
    if n == 0:
        return out
    lib = writeback._load()
    ints = lib.guber_seg_scan_totals(n, k)
    totals = torch.empty(ints, dtype=torch.int32, device=out.device) if ints > 0 else None
    with torch.cuda.device(out.device):
        writeback._launch(name, lambda lib, s: lib.guber_seg_scan(
            None if is_leader is None else is_leader.data_ptr(),
            None if values is None else values.data_ptr(), out.data_ptr(),
            None if totals is None else totals.data_ptr(), n, k, mode, width, s))
    if torch.cuda.is_current_stream_capturing():
        seg_scan.captured += 1
    else:
        seg_scan.launches += 1
    return out


def seg_scan(is_leader: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """int32 [N, K]: the segmented saturating inclusive prefix sums of
    the non-negative int32 `values` [N, K] over the segments `is_leader`
    (bool[N]) starts. CPU tensors take seg_scan_plain; CUDA tensors launch
    the kernel. Negative values are outside the contract (the kernel's
    saturation assumes none, and no device check is made: it would cost a
    sync)."""
    if _check("seg_scan", is_leader, values) == "cpu":
        return seg_scan_plain(is_leader, values)
    return _launch("seg_scan", is_leader, values, _MODE_SUM)


seg_scan.launches = 0
seg_scan.captured = 0


def leader_pos(is_leader: torch.Tensor) -> torch.Tensor:
    """int32[N]: each row's segment start. CPU tensors take
    leader_pos_plain; CUDA tensors launch the kernel (counted in
    seg_scan's counts)."""
    if _check("leader_pos", is_leader, None) == "cpu":
        return leader_pos_plain(is_leader)
    return _launch("leader_pos", is_leader, None, _MODE_START)


def segment_ends(is_leader: torch.Tensor) -> torch.Tensor:
    """int32[N]: each row's inclusive segment end. CPU tensors take
    segment_ends_plain; CUDA tensors launch the kernel (counted in
    seg_scan's counts)."""
    if _check("segment_ends", is_leader, None) == "cpu":
        return segment_ends_plain(is_leader)
    return _launch("segment_ends", is_leader, None, _MODE_END)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """int32 [G, W]: each row's inclusive prefix sum across the columns
    of the non-negative int32 `x` [G, W] (contiguous), saturating at
    2^31-1. CPU tensors take row_cumsum_plain; CUDA tensors launch the
    kernel with a segment every W elements (counted in seg_scan's
    counts)."""
    if x.dtype != torch.int32:
        raise TypeError(f"row_cumsum: x must be int32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("row_cumsum: x must be a contiguous [G, W] tensor")
    if x.device.type == "cpu":
        return row_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_cumsum: unsupported device {x.device}")
    if x.numel() >= 1 << 31:
        raise ValueError(f"row_cumsum: {x.numel()} elements past the kernel's 32-bit count")
    G, W = x.shape
    return _launch("row_cumsum", None, x.view(G * W, 1), _MODE_SUM, W).view(G, W)


def count_replay(n: int) -> None:
    """A replay of a captured graph that recorded `n` scan calls has
    launched them (core/graphs.py DeviceGraphs.replay)."""
    seg_scan.launches += n
