"""ycsb-zipfian: YCSB's `requestdistribution=zipfian` key chooser, drawn
fresh for every row and folded into the key space.

YCSB (Cooper et al., "Benchmarking Cloud Serving Systems with YCSB",
SoCC 2010), core workloads: CoreWorkload picks keys with
`ScrambledZipfianGenerator(0, recordcount - 1)`. That generator draws a
rank from `ZipfianGenerator(0, ITEM_COUNT, 0.99, ZETAN)` (Gray et al.,
"Quickly Generating Billion-Record Synthetic Databases", SIGMOD 1994)
and returns `min + fnvhash64(rank) % itemcount`. Its constants:

    ZIPFIAN_CONSTANT  theta = 0.99
    ITEM_COUNT        10^10: the generator spans ranks 0..ITEM_COUNT,
                      so n = ITEM_COUNT + 1 items (max - min + 1)
    ZETAN             26.46902820178302 (zeta(n, 0.99), precomputed)

and Gray's closed form, as ZipfianGenerator.nextLong computes it from
one uniform u in [0, 1):

    zeta2  = 1 + 0.5^theta                     (zeta(2, theta))
    alpha  = 1 / (1 - theta)
    eta    = (1 - (2 / n)^(1 - theta)) / (1 - zeta2 / zetan)
    uz     = u * zetan
    rank   = 0                                  if uz < 1
             1                                  if uz < 1 + 0.5^theta
             (long) (n * (eta*u - eta + 1)^alpha)   otherwise

`fnvhash64` (YCSB's Utils) is FNV-1a over the rank's 8 bytes, low byte
first: h = 0xCBF29CE484222325; for each byte, h ^= byte, h *= 1099511628211
(mod 2^64); then the absolute value of h as a signed 64-bit integer. The
one value whose absolute value Java leaves negative (h = -2^63) is taken
here as 2^63, so every id lies in [0, key_space).

`scrambled` false returns rank % key_space (YCSB's plain `zipfian` over
the ranks, hottest id 0) instead of the FNV fold.

Chunk c of a run's stream is drawn from numpy's default_rng([seed, c]),
so a seed gives the same ids whichever thread draws them.

Parameters: `theta` (0.99), `items` (1e10, ITEM_COUNT), `zetan`
(26.46902820178302, which belongs to theta 0.99 and 1e10 items only),
`scrambled` (true)."""

from __future__ import annotations

import numpy as np

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
ZETAN = 26.46902820178302
ITEM_COUNT = 10_000_000_000
THETA = 0.99


def fnvhash64(v: np.ndarray, nbytes: int = 8) -> np.ndarray:
    """YCSB's Utils.fnvhash64 of non-negative int64 values, as uint64 (the
    absolute value of the signed hash). Values below 2^(8 nbytes) may say
    so: the bytes above are zero, and a zero byte's round is the multiply
    alone, so those rounds are one multiply by a power of the prime."""
    octets = np.ascontiguousarray(v, "<i8").view(np.uint8).reshape(-1, 8)
    prime = np.uint64(FNV_PRIME_64)
    h = np.full(octets.shape[0], FNV_OFFSET_BASIS_64, np.uint64)
    for i in range(nbytes):
        np.bitwise_xor(h, octets[:, i], out=h, casting="unsafe")
        np.multiply(h, prime, out=h)
    if nbytes < 8:
        np.multiply(h, np.uint64(pow(FNV_PRIME_64, 8 - nbytes, 1 << 64)), out=h)
    neg = h >= np.uint64(1 << 63)
    return np.where(neg, np.uint64(0) - h, h)  # two's-complement negation: |h|


class Zipfian:
    """ZipfianGenerator's closed form over `items` + 1 ranks."""

    def __init__(self, theta: float = THETA, items: int = ITEM_COUNT, zetan: float = ZETAN):
        self.theta = float(theta)
        self.n = float(int(items) + 1)
        self.zetan = float(zetan)
        self.zeta2 = 1.0 + 0.5 ** self.theta  # also where rank 1's draws end
        self.alpha = 1.0 / (1.0 - self.theta)
        self.eta = (1.0 - (2.0 / self.n) ** (1.0 - self.theta)) / (1.0 - self.zeta2 / self.zetan)
        # bytes of the largest rank: n itself, where eta*u - eta + 1 rounds to 1
        self.nbytes = -(-int(items + 1).bit_length() // 8)

    def ranks(self, u: np.ndarray) -> np.ndarray:
        """int64 ranks of uniforms `u` in [0, 1)."""
        uz = u * self.zetan
        r = (self.n * np.power(self.eta * u - self.eta + 1.0, self.alpha)).astype(np.int64)
        r[uz < self.zeta2] = 1
        r[uz < 1.0] = 0
        return r


class Stream:
    def __init__(self, params: dict, key_space: int, seed: int, start: int = 0):
        self.key_space = int(key_space)
        self.seed = int(seed) % (1 << 64)
        self.gen = Zipfian(float(params.get("theta", THETA)), int(float(params.get("items", ITEM_COUNT))),
                           float(params.get("zetan", ZETAN)))
        self.scrambled = bool(params.get("scrambled", True))

    def ids(self, k: int, rows: int) -> np.ndarray:
        """The k-th `rows` rows of the stream, fresh draws."""
        u = np.random.default_rng([self.seed, int(k)]).random(rows)
        r = self.gen.ranks(u)
        if self.scrambled:
            return (fnvhash64(r, self.gen.nbytes) % np.uint64(self.key_space)).astype(np.int64)
        return r % self.key_space
