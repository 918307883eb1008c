"""Algorithm registry (the part of gubernator_tpu.core.algorithms that
the exact-tier decide reads).

Ids are the wire enum (api.types.Algorithm) and the decide's `algo`
column; each stored algorithm other than token owns one FLAG_ALGO_* bit
of the store's flags lane (core.store), token being the all-zero
encoding. The per-algorithm state layout and integer conventions are
documented at gubernator_tpu/core/algorithms.py:1-101 and are the ones
core.kernels implements.
"""

ALGO_TOKEN = 0
ALGO_LEAKY = 1
ALGO_SLIDING = 2
ALGO_GCRA = 3

#: Sliding-window duration cap: half the generic MAX_DURATION_MS, so the
#: expire anchor window_start + 2*duration stays inside int32 with
#: engine now <= 2^30. The decide clips stored and requested durations
#: to [1, SLIDING_MAX_DURATION_MS] identically.
SLIDING_MAX_DURATION_MS = (1 << 29) - 1
