"""Peer routing: consistent-hash ownership + the peer client (the port of
gubernator_tpu/serve/peers.py).

The ring is the reference's, copied: a crc32 point per peer, a sorted
ring, binary-search successor with wraparound (reference hash.go:62-96),
so a mixed cluster would agree on key ownership. The picker's successor
and ownership-diff queries serve replication, rescale and the edge
bridge, which are not ported yet, and are left out with them.

`PeerClient` keeps the reference's construction, per-peer circuit breaker
and address validation (`connect`), but opens no gRPC channel: forwarding
to another node needs the PeersV1 door, which comes with the doors'
slice of the port. Until then every forwarding call raises, and
Instance.set_peers accepts only a ring whose one member is this node.
"""

from __future__ import annotations

import bisect
import logging
from typing import Dict, List, Optional

from gubernator_tpu_torch.core.hashing import ring_hash
from gubernator_tpu_torch.serve import metrics
from gubernator_tpu_torch.serve.breaker import CircuitBreaker
from gubernator_tpu_torch.serve.config import BehaviorConfig

log = logging.getLogger("gubernator_tpu_torch.peers")

FORWARDING_NOT_PORTED = (
    "forwarding to other nodes is not ported to gubernator_tpu_torch yet; "
    "it comes with the doors' slice (the PeersV1 gRPC service)"
)


class PeerClient:
    """One ring member (possibly this server itself)."""

    def __init__(
        self,
        conf: BehaviorConfig,
        host: str,
        is_owner: bool = False,
        mesh_local: bool = False,
    ):
        self.conf = conf
        self.host = host
        self.is_owner = is_owner  # true when this peer is this server
        self.mesh_local = mesh_local
        self._closed = False
        # per-peer circuit breaker: survives set_peers churn because
        # existing clients are reused there
        self.breaker = self._make_breaker()

    def _make_breaker(self) -> Optional[CircuitBreaker]:
        c = self.conf
        if getattr(c, "breaker_failures", 0) <= 0:
            return None  # GUBER_BREAKER_FAILURES=0 disables

        def on_transition(frm: str, to: str) -> None:
            from gubernator_tpu_torch.serve.breaker import STATE_CODES

            log.warning("peer '%s' circuit breaker: %s -> %s", self.host, frm, to)
            try:
                metrics.PEER_BREAKER_TRANSITIONS.labels(peer=self.host, to=to).inc()
                metrics.PEER_BREAKER_STATE.labels(peer=self.host).set(STATE_CODES[to])
            except Exception:  # pragma: no cover - defensive
                pass

        return CircuitBreaker(
            failures=c.breaker_failures,
            ratio=c.breaker_ratio,
            window=c.breaker_window,
            cooldown=c.breaker_cooldown,
            probes=c.breaker_probes,
            on_transition=on_transition,
        )

    def connect(self) -> None:
        """Validate the target's syntax eagerly, as the reference does
        before dialing: health then reports a malformed peer. No channel
        is opened (see the module docstring)."""
        self._closed = False
        host, _, port = self.host.rpartition(":")
        if not host or not port.isdigit() or not (0 < int(port) < 65536):
            raise ValueError(f"invalid peer address {self.host!r}")

    async def close(self) -> None:
        self._closed = True

    # -- forwarding: comes with the doors' slice ----------------------------

    async def get_peer_rate_limit(self, r):
        raise NotImplementedError(FORWARDING_NOT_PORTED)

    async def get_peer_rate_limits_grouped(self, reqs):
        raise NotImplementedError(FORWARDING_NOT_PORTED)

    async def get_peer_rate_limits(self, reqs, traceparent=None):
        raise NotImplementedError(FORWARDING_NOT_PORTED)

    async def update_peer_globals(self, updates) -> None:
        raise NotImplementedError(FORWARDING_NOT_PORTED)


class ConsistentHashPicker:
    """Ring-placement-compatible peer picker (reference hash.go)."""

    def __init__(self, hash_fn=ring_hash):
        self._hash = hash_fn
        self._keys: List[int] = []
        self._by_point: Dict[int, PeerClient] = {}
        self._by_host: Dict[str, PeerClient] = {}

    def new(self) -> "ConsistentHashPicker":
        return ConsistentHashPicker(self._hash)

    def add(self, peer: PeerClient) -> None:
        point = self._hash(peer.host)
        existing = self._by_point.get(point)
        if existing is not None and existing.host != peer.host:
            # two addresses on one crc32 point would silently split
            # ownership between pickers: refuse loudly (set_peers
            # surfaces it through health)
            raise ValueError(
                f"ring point collision: '{peer.host}' and "
                f"'{existing.host}' both hash to {point:#x}; rename one "
                f"peer address (placement would silently diverge "
                f"between pickers)"
            )
        if existing is None:
            bisect.insort(self._keys, point)
        self._by_point[point] = peer
        self._by_host[peer.host] = peer

    def size(self) -> int:
        return len(self._keys)

    def peers(self) -> List[PeerClient]:
        return list(self._by_host.values())

    def get_peer_by_host(self, host: str) -> Optional[PeerClient]:
        return self._by_host.get(host)

    def get(self, key: str) -> PeerClient:
        """Successor peer on the ring for this key's point, wrapping
        (reference hash.go:80-96)."""
        if not self._keys:
            raise RuntimeError("unable to pick a peer; pool is empty")
        point = self._hash(key)
        i = bisect.bisect_left(self._keys, point)
        if i == len(self._keys):
            i = 0
        return self._by_point[self._keys[i]]
