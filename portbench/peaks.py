"""The card's published peaks and the bytes arithmetic of the port's one
hand-written kernel, for roofline metrics that a later change adds as
reader files (the counts they need, rows handed to each writeback and
distinct buckets a batch, are not exposed by the program yet).

A copy of chip_smoke.py's `HBM_BYTES_PER_S` and `kernel_case` byte count.
"""

from __future__ import annotations

#: H100 SXM data sheet: HBM3 at 3.35 TB/s, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12

LANES_PER_ROW = 128  # int32 words in a store bucket row


def writeback_bytes(groups: int, touched_rows: int, lanes: int = LANES_PER_ROW) -> int:
    """Least bytes one `writeback_add` call moves: each group's delta row
    and bucket id read once, each touched store row read and written once."""
    return groups * lanes * 4 + groups * 4 + 2 * touched_rows * lanes * 4


def roofline_share(nbytes: float, seconds: float) -> float:
    """Share of the bytes roofline: the least time the bytes need at the
    published peak over the time taken (never clipped; above 1 means the
    bytes are counted too high or the time misses work)."""
    return nbytes / HBM_BYTES_PER_S / seconds
