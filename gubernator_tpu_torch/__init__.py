"""gubernator-tpu on PyTorch and CUDA: the rate limiter's two-tier store
(exact slot store + count-min cold tier) for one NVIDIA GPU.

A port of `gubernator_tpu` (the JAX/TPU package, which stays the
reference) with the same module names, so each counterpart is found in
the same place:

- `api.types`: the wire-level request/response types (a copy).
- `core.hashing`, `core.store`, `core.algorithms`: key hashing, the
  dense int32 slot store and its lane layout, the algorithm registry.
- `core.sketches`: the cold tier's geometry, the MiB carve-out of both
  tiers, and the host twins of its indexing.
- `core.kernels`: the batched decide (exact tier and two-tier), the
  device-sorted `decide` and the window install `upsert_globals`, as
  eager tensor code.
- `core.writeback`: the store writeback, a hand-written CUDA kernel for
  Hopper (`csrc/writeback.cu`) beside its plain PyTorch version.
- `core.cache`, `core.oracle`: the host LRU and the exact algorithms
  over it (copies), which the exact backend decides with.
- `core.engine`, `parallel.sharded`: host glue and the single-device
  `TorchEngine`, with the arrival-prep, GLOBAL, promoter and
  export/repartition surfaces.
- `serve`: the serving core: `Instance`, the `DeviceBatcher` (arrival
  prep, deep batches, pipelined fetch), `TorchBackend`, `ExactBackend`
  and `make_backend`, the over-limit shed cache, the sketch promoter loop,
  the GLOBAL manager, bucket replication, ring rescale and
  checkpoint/restore, config, metrics and tracing; the doors
  (`serve.server`: gRPC, HTTP JSON, `/metrics`; `serve.edge_bridge` and
  `serve.shm`: the GEB frame doors and the shared-memory lane) and the
  daemon, `cluster` and the clients (`client`, `client_geb`).
- `native`: the compiled edge's sources (a copy) and their g++ build.

The package imports `torch`, numpy and (in `serve.metrics`)
`prometheus_client`, never `jax`, and nothing of `gubernator_tpu`. Entry points run on `cuda` unless the caller passes
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
