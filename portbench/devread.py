"""What the recorder reads of the port's state on the device, in stream
order and without a sync: a 64-bit digest of every store row and of every
chunk of 128 sketch counters, and the sketch counters that a batch's
eviction victims can read. Each has a NumPy twin here, which the
comparison uses to check the device's readings.

The digest of a row of words w_0 .. w_{L-1} is the sum, modulo 2^64, of
f(w_l, l) over its lanes, where

    f(w, l) = g(M2 * g(M1 * (sext64(w) ^ s_l))),   g(x) = x ^ (x >>> 32),

s_l is a 64-bit salt of lane l drawn from the run's seed, and M1, M2 are
odd. Sign extension to 64 bits is injective; xor with a constant,
multiplication by an odd number modulo 2^64 and g are each a bijection
of 64-bit words. So f(., l) is injective, and a change of exactly one
word changes its lane's term and nothing else: the digest changes with
certainty. A change of several words moves the digest by a sum of
differences of f; modelled as a random function, f makes that sum 0 modulo
2^64 with chance 2^-64, and the seeded salts keep any one pattern of words
from cancelling in every run. The digest is a sum, so a digest can be
brought up to date from the words that changed alone (`term_np`), which
is how the comparison checks a chunk it holds only some counters of.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.limiter import (
    L_DURATION,
    L_EXPIRE,
    L_KEYLOW,
    L_TAG,
    LANES,
    SKETCH_SALTS,
    WINDOW_MIX,
    mix64,
)

CHUNK = 128  # sketch counters a digest
M1 = 0xFF51AFD7ED558CCD
M2 = 0xC4CEB9FE1A85EC53
I32_MIN = -(1 << 31)
M32 = 0xFFFFFFFF


def as_i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def lane_salts(seed: int, lanes: int) -> np.ndarray:
    """uint64[lanes]: the digest's salt of each lane for this seed."""
    base = mix64(np.array([seed % (1 << 64)], np.uint64) ^ np.uint64(0xD1CE5EED))[0]
    return mix64(base + np.arange(1, lanes + 1, dtype=np.uint64))


# -- NumPy ---------------------------------------------------------------------


def term_np(words: np.ndarray, lanes: np.ndarray, salts: np.ndarray) -> np.ndarray:
    """uint64 f(word, lane) of each word (any integer dtype of at most 64
    bits, taken as signed) at its lane."""
    with np.errstate(over="ignore"):
        x = np.asarray(words).astype(np.int64).view(np.uint64) ^ salts[np.asarray(lanes)]
        x = x * np.uint64(M1)
        x ^= x >> np.uint64(32)
        x = x * np.uint64(M2)
        x ^= x >> np.uint64(32)
    return x


def digest_np(rows: np.ndarray, salts: np.ndarray) -> np.ndarray:
    """uint64 digest of each row of a 2-D array."""
    t = term_np(rows, np.arange(rows.shape[1])[None, :], salts)
    with np.errstate(over="ignore"):
        return t.sum(axis=1, dtype=np.uint64)


# -- torch, on the state's device ------------------------------------------------


def mix64_t(x):
    """`reference.limiter.mix64` on int64 tensors (uint64 bits): the
    logical shifts are arithmetic ones masked."""
    x = x ^ ((x >> 30) & ((1 << 34) - 1))
    x = x * as_i64(0xBF58476D1CE4E5B9)
    x = x ^ ((x >> 27) & ((1 << 37) - 1))
    x = x * as_i64(0x94D049BB133111EB)
    return x ^ ((x >> 31) & ((1 << 33) - 1))


class Digester:
    """Digests of the rows of 2-D int32 or int64 tensors into int64
    tensors, a block of rows at a time through one workspace made here, so
    that no temporary is the size of the state. `into` writes the digests;
    `subtract` takes them from what is there."""

    def __init__(self, salts: np.ndarray, max_width: int, block_rows: int, device):
        import torch

        self.block_rows = int(block_rows)
        self.salts = torch.from_numpy(salts[:max_width].view(np.int64).copy()).to(device)
        self.ws = torch.empty(self.block_rows * max_width, dtype=torch.int64, device=device)
        self.sums = torch.empty(self.block_rows, dtype=torch.int64, device=device)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.salts, self.ws, self.sums))

    def _blocks(self, rows):
        import torch

        n, w = rows.shape
        for i in range(0, n, self.block_rows):
            j = min(n, i + self.block_rows)
            x = self.ws[:(j - i) * w].view(j - i, w)
            x.copy_(rows[i:j])
            x.bitwise_xor_(self.salts[:w])
            x.mul_(as_i64(M1))
            half = x.view(torch.int32).view(j - i, w, 2)  # little-endian (low, high) halves
            half[..., 0].bitwise_xor_(half[..., 1])
            x.mul_(as_i64(M2))
            half[..., 0].bitwise_xor_(half[..., 1])
            yield i, j, x

    def into(self, out, rows) -> None:
        import torch

        for i, j, x in self._blocks(rows):
            torch.sum(x, dim=1, out=out[i:j])

    def subtract(self, out, rows) -> None:
        import torch

        for i, j, x in self._blocks(rows):
            torch.sum(x, dim=1, out=self.sums[:j - i])
            out[i:j].sub_(self.sums[:j - i])


def victim_counters(rows, e_now: int, ways: int, sketch_rows: int, width: int, out) -> None:
    """Into int64 `out` [sketch_rows * n]: the flat sketch index (row r at
    r * width) of the counters that each of the n store rows' eviction
    victim can read at engine time `e_now`: the entry a create would evict
    (the first empty way, else the first of least expiry), its key from
    tag and key-low, at its window now // duration. `reference.limiter.
    needed_counters` names the same counters (an empty way's are extra)."""
    import torch

    n = rows.shape[0]
    e = rows.view(n, ways, LANES)
    tag = e[:, :, L_TAG]
    way = torch.where(tag == 0, torch.full_like(tag, I32_MIN), e[:, :, L_EXPIRE]).argmin(dim=1)
    v = e[torch.arange(n, device=rows.device), way].long()
    key = ((v[:, L_TAG] & M32) << 32) | (v[:, L_KEYLOW] & M32)
    wid = torch.div(torch.full_like(key, int(e_now)), v[:, L_DURATION].clamp(min=1),
                    rounding_mode="floor")
    base = mix64_t(key ^ (wid * as_i64(WINDOW_MIX)))
    for r in range(sketch_rows):
        torch.bitwise_and(mix64_t(base ^ as_i64(SKETCH_SALTS[r])), width - 1,
                          out=out[r * n:(r + 1) * n])
        out[r * n:(r + 1) * n].add_(r * width)
