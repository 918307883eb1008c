"""zipf: ids drawn fresh from zipf(a) and folded into the key space, so id
1 is the hottest key. The distribution is that of
gubernator_tpu_torch/cli/keystreams.py `zipf_ids` (numpy's
Generator.zipf, a = 1.2 there as `ZIPF_A`, then `% key_space`), drawn by a
sampler about ten times faster, so that every row of a run can be a fresh
draw: ids 1..head by an alias table over their exact probabilities
k^-a / Z; larger ids from the tail's continuous form
P(X >= m | X > head) = ((m - 1/2) / (head + 1/2))^(1 - a), whose
probabilities differ from k^-a / Z by under a(a + 1) / (24 m^2) of
themselves (under 1e-10 past head = 2^16). Draws past 2^53, which no
float holds exactly, fold to a uniform id, as their fold nearly is.

Chunk c of a run's stream is drawn from numpy's default_rng([seed, c]),
so a seed gives the same ids whichever thread draws them.

Parameters: `a` (default 1.2), `head` (default 65,536)."""

from __future__ import annotations

import numpy as np

def _alias(p: np.ndarray):
    """Vose's alias table of probabilities `p` (summing to 1)."""
    n = p.shape[0]
    scaled = p * n
    prob = np.zeros(n)
    alias = np.zeros(n, np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    sc = scaled.tolist()
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s], alias[s] = sc[s], g
        sc[g] -= 1.0 - sc[s]
        (small if sc[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i], alias[i] = 1.0, i
    return prob, alias


def table(a: float, head: int):
    """(tail mass, alias probabilities, aliases) of zipf(a) with ids
    1..head in the alias table."""
    k = np.arange(1, head + 1, dtype=np.float64)
    w = k ** -a
    tail = (head + 0.5) ** (1.0 - a) / (a - 1.0)
    prob, alias = _alias(w / w.sum())
    return tail / (w.sum() + tail), prob, alias.astype(np.int32)


def zipf_draw(key_space: int, size: int, rng: np.random.Generator, a: float, tab) -> np.ndarray:
    """int64[size] zipf(a) draws folded into [0, key_space); `tab` is
    table(a, head)."""
    t_mass, prob, alias = tab
    head = prob.shape[0]
    u = rng.random(size)
    r = rng.random(size) * head  # the alias slot, and the uniform within it
    i = r.astype(np.int32)
    out = np.where(r - i < prob[i], i, alias[i]).astype(np.int64) + 1
    tail = np.flatnonzero(u < t_mass)
    if tail.size:
        w = 1.0 - u[tail] / t_mass  # uniform in (0, 1]
        m = np.floor((head + 0.5) * w ** (1.0 / (1.0 - a)) + 0.5)
        huge = m >= 2.0 ** 53
        m = np.where(huge, 0.0, m).astype(np.int64)
        m[huge] = rng.integers(0, key_space, int(huge.sum()))
        out[tail] = m
    if head >= key_space:
        return out % int(key_space)
    out[tail] %= int(key_space)
    return out


class Stream:
    def __init__(self, params: dict, key_space: int, seed: int, start: int = 0):
        self.key_space = int(key_space)
        self.seed = int(seed) % (1 << 64)
        self.a = float(params.get("a", 1.2))
        self.table = table(self.a, int(params.get("head", 1 << 16)))

    def ids(self, k: int, rows: int) -> np.ndarray:
        """The k-th `rows` rows of the stream, fresh draws."""
        rng = np.random.default_rng([self.seed, int(k)])
        return zipf_draw(self.key_space, rows, rng, self.a, self.table)
