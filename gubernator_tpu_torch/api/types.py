"""Core data model: the wire-level types of the rate-limit API.

Mirrors the reference proto contract (reference proto/gubernator.proto:57-153,
proto/peers.proto:36-56) as plain Python dataclasses used throughout the
host-side code. The actual protobuf classes (for gRPC) are generated from our
own .proto files and converted to/from these types at the serving edge.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Duration constants in milliseconds (reference client.go:27-31).
MILLISECOND = 1
SECOND = 1000 * MILLISECOND
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE


class Algorithm(enum.IntEnum):
    """Rate-limit algorithm (reference proto/gubernator.proto:57-62;
    SLIDING_WINDOW/GCRA are the r15 suite — core/algorithms.py)."""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1
    SLIDING_WINDOW = 2
    GCRA = 3


class Behavior(enum.IntEnum):
    """Request routing behavior (reference proto/gubernator.proto:64-95).

    BATCHING    — forward to the owning peer through the micro-batching queue.
    NO_BATCHING — forward with a direct unary RPC (lowest latency).
    GLOBAL      — answer from the local replica cache; hits are aggregated and
                  pushed to the owner asynchronously, and the owner broadcasts
                  authoritative status back to all peers.
    """

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2


class Status(enum.IntEnum):
    """Decision status (reference proto/gubernator.proto:125-128)."""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


@dataclass
class ChainLevel:
    """One ancestor level of a hierarchical quota chain (r15).

    A chained request debits `chain[0] -> chain[1] -> ... -> leaf`
    (shallow to deep: global first, the request's own key last) in ONE
    device pass with most-restrictive-wins semantics and the
    no-partial-debit contract (a refused level consumes quota at no
    other level). Each level is a real counter under the request's
    `name` namespace, shared by every chain with the same HEAD (and by
    plain requests for the head's own key): the tenant level IS the
    tenant's limit. Ancestor levels always decide as TOKEN buckets —
    only the leaf uses the request's algorithm — so one hierarchy
    serves callers with different leaf algorithms without the shared
    counters mismatch-recreating. On sharded topologies a chain's levels live on the
    head's owner shard (the consolidation contract,
    parallel/sharded.py pad_request_chained), so well-formed
    hierarchies keep one head per subtree. `duration=0` inherits the
    request's duration."""

    unique_key: str = ""
    limit: int = 0
    duration: int = 0


@dataclass
class RateLimitReq:
    """One rate-limit request (reference proto/gubernator.proto:97-123).

    duration is in milliseconds. hits == 0 is a read-only peek.
    `chain` (r15) lists ancestor quota levels, shallow to deep; empty =
    a plain single-level request. Chained requests are routed by the
    chain HEAD's key so one owner debits the whole chain atomically,
    and are incompatible with Behavior.GLOBAL (validated serving-side).
    """

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0
    algorithm: Algorithm = Algorithm.TOKEN_BUCKET
    behavior: Behavior = Behavior.BATCHING
    chain: List["ChainLevel"] = field(default_factory=list)

    def hash_key(self) -> str:
        return hash_key(self.name, self.unique_key)

    def routing_key(self) -> str:
        """The ring/ownership key: the chain head's for chained
        requests (the whole chain lands on one owner), else the
        request's own."""
        if self.chain:
            return hash_key(self.name, self.chain[0].unique_key)
        return self.hash_key()


@dataclass
class RateLimitResp:
    """One rate-limit decision (reference proto/gubernator.proto:130-143)."""

    status: Status = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class HealthCheckResp:
    """Server health (reference proto/gubernator.proto:146-153)."""

    status: str = ""
    message: str = ""
    peer_count: int = 0


@dataclass
class GetRateLimitsReq:
    requests: List[RateLimitReq] = field(default_factory=list)


@dataclass
class GetRateLimitsResp:
    responses: List[RateLimitResp] = field(default_factory=list)


@dataclass
class UpdatePeerGlobal:
    """One GLOBAL status broadcast entry (reference proto/peers.proto:52-55)."""

    key: str = ""
    status: Optional[RateLimitResp] = None


@dataclass
class PeerInfo:
    """Cluster membership entry (reference etcd.go:34 usage / cluster.go)."""

    address: str = ""
    is_owner: bool = False
    #: this peer's replica state lives in THIS node's mesh (a lockstep
    #: follower process or a co-scheduled server sharing the device
    #: store): replica-install broadcasts to it collapse into one local
    #: mesh install instead of a per-peer RPC (r21, global_mgr.py)
    mesh_local: bool = False


def hash_key(name: str, unique_key: str) -> str:
    """The canonical cache/ring key: `name + "_" + unique_key`
    (reference client.go:33-35)."""
    return name + "_" + unique_key


def millisecond_now() -> int:
    """Wall clock in unix milliseconds (reference cache/lru.go MillisecondNow)."""
    return time.time_ns() // 1_000_000


def over_limit_resp(limit: int, reset_time: int) -> RateLimitResp:
    """The frozen token-bucket refusal: status OVER_LIMIT, remaining 0.
    This is the exact response an existing zero-remaining token window
    returns for every hit-carrying request until it expires (the
    verdict the over-limit shed cache serves host-side,
    serve/shedcache.py)."""
    return RateLimitResp(
        status=Status.OVER_LIMIT,
        limit=limit,
        remaining=0,
        reset_time=reset_time,
    )


def resps_from_columns(status, limit, remaining, reset) -> List[RateLimitResp]:
    """RateLimitResp list from four parallel numpy response columns —
    the single device-array -> object seam (engine response fetch,
    serving backends). Batch ndarray->list conversion (one C pass per
    column, Python ints out) instead of 4n numpy scalar extractions:
    the int(arr[i]) loop was the response side's dominant per-item
    cost at 1000-item groups."""
    return [
        RateLimitResp(
            status=Status(s), limit=li, remaining=r, reset_time=t
        )
        for s, li, r, t in zip(
            status.tolist(), limit.tolist(), remaining.tolist(),
            reset.tolist(),
        )
    ]
