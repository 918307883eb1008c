"""gubernator-tpu on PyTorch and CUDA: the rate limiter's exact tier for
one NVIDIA GPU.

A port of `gubernator_tpu` (the JAX/TPU package, which stays the
reference) with the same module names, so each counterpart is found in
the same place:

- `api.types`: the wire-level request/response types (a copy).
- `core.hashing`, `core.store`, `core.algorithms`: key hashing, the
  dense int32 slot store and its lane layout, the algorithm registry.
- `core.kernels`: the exact-tier batched decide, as eager tensor code.
- `core.writeback`: the store writeback, a hand-written CUDA kernel for
  Hopper (`csrc/writeback.cu`) beside its plain PyTorch version.
- `core.engine`, `parallel.sharded`: host glue and the single-device
  `TorchEngine`.

The package imports `torch` and numpy, never `jax`, and nothing of
`gubernator_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; with no device given and no GPU present they raise.
This root imports no torch either, so the API types load anywhere.
"""

from gubernator_tpu_torch.api.types import (
    HOUR,
    MILLISECOND,
    MINUTE,
    SECOND,
    Algorithm,
    Behavior,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
    Status,
    hash_key,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Behavior",
    "Status",
    "RateLimitReq",
    "RateLimitResp",
    "HealthCheckResp",
    "hash_key",
    "MILLISECOND",
    "SECOND",
    "MINUTE",
    "HOUR",
    "__version__",
]
