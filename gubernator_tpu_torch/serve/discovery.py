"""Cluster membership discovery (the port of gubernator_tpu/serve/discovery.py).

The port carries the static pool: a fixed peer list (the reference's
GUBER_PEERS-style wiring and test-cluster path, cluster/cluster.go:36-46).
It pushes a full `[]PeerInfo` snapshot through `on_update`, and the
instance rebuilds its ring (reference etcd.go:308-316 -> SetPeers).

The etcd and Kubernetes pools are not ported yet: a config that selects
one (GUBER_ETCD_ENDPOINTS, GUBER_K8S_ENDPOINTS_SELECTOR) is refused when
the server is built (serve/server.py `refuse_not_ported`).
"""

from __future__ import annotations

from typing import Awaitable, Callable, List, Sequence

from gubernator_tpu_torch.api.types import PeerInfo

OnUpdate = Callable[[List[PeerInfo]], Awaitable[None]]


class StaticPool:
    """Fixed membership; fires one update at start."""

    def __init__(
        self, peers: Sequence[str], advertise: str, on_update: OnUpdate
    ):
        self.peers = list(peers)
        self.advertise = advertise
        self.on_update = on_update

    async def start(self) -> None:
        await self.on_update(
            [
                PeerInfo(address=p, is_owner=(p == self.advertise))
                for p in self.peers
            ]
        )

    async def close(self) -> None:
        pass
