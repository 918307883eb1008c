"""Algorithm registry and the sketch tier's host twins (the parts of
gubernator_tpu.core.algorithms that the decide, the serving tier and the
tests read).

Ids are the wire enum (api.types.Algorithm) and the decide's `algo`
column; each stored algorithm other than token owns one FLAG_ALGO_* bit
of the store's flags lane (core.store), token being the all-zero
encoding. The per-algorithm state layout and integer conventions are
documented at gubernator_tpu/core/algorithms.py:1-101 and are the ones
core.kernels implements.

`sketch_sliding_budget` / `sketch_gcra_budget` are the host twins of the
decide's sketch branch for sliding windows (the window-ring blend of the
current and previous epoch window's estimates) and GCRA (a theoretical
arrival time re-quantized from the same two estimates); the tests hold
the device branch against them bit for bit.
"""

from typing import Tuple

ALGO_TOKEN = 0
ALGO_LEAKY = 1
ALGO_SLIDING = 2
ALGO_GCRA = 3

_I32_MAX = (1 << 31) - 1

#: Sliding-window duration cap: half the generic MAX_DURATION_MS, so the
#: expire anchor window_start + 2*duration stays inside int32 with
#: engine now <= 2^30. The decide clips stored and requested durations
#: to [1, SLIDING_MAX_DURATION_MS] identically.
SLIDING_MAX_DURATION_MS = (1 << 29) - 1

#: algorithms whose dropped creates the count-min tier serves (all four:
#: token/leaky on fixed-window math, sliding and GCRA from the ring)
SKETCH_SERVABLE_ALGOS = frozenset({ALGO_TOKEN, ALGO_LEAKY, ALGO_SLIDING, ALGO_GCRA})

#: shed-cache gate (serve/shedcache.py): algorithms whose over-limit
#: verdict is frozen for the rest of the window
SHEDDABLE_ALGOS = frozenset({ALGO_TOKEN})

#: sketch promotion gate (serve/promoter.py): install_windows writes the
#: token fixed-window layout, so only token keys promote
PROMOTABLE_ALGOS = frozenset({ALGO_TOKEN})


def gcra_params(limit: int, duration: int) -> Tuple[int, int]:
    """(emission interval T, burst tolerance tau), both ms."""
    T = max(duration // max(limit, 1), 1)
    tau = min(T * max(limit, 0), _I32_MAX)
    return T, tau


def sketch_sliding_budget(
    est_cur: int, est_prev: int, now: int, limit: int, duration: int
) -> Tuple[int, int]:
    """(budget, reset) of a sketch-served SLIDING decision: estimates
    clamped to the limit, the previous window's weighted by its overlap."""
    d = max(duration, 1)
    wid = now // d
    wend = (wid + 1) * d
    lim = max(limit, 0)
    used = min(est_cur, lim) + (min(est_prev, lim) * (wend - now)) // d
    return max(min(limit - used, lim), 0), wend


def sketch_gcra_budget(
    est_cur: int, est_prev: int, now: int, limit: int, duration: int
) -> Tuple[int, int]:
    """(budget, TAT_q) of a sketch-served GCRA decision: the theoretical
    arrival time re-quantized from the two ring estimates."""
    T, tau = gcra_params(limit, duration)
    d = max(duration, 1)
    ws = (now // d) * d
    lim = max(limit, 0)
    tatq = max(ws - d + tau + T, now) + (min(est_cur, lim) + min(est_prev, lim)) * T
    return max(min((now + tau - tatq) // T, lim), 0), tatq
