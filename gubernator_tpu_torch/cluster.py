"""In-process cluster: N real servers, real localhost gRPC, one process
(the port of gubernator_tpu/cluster.py).

The multi-node pattern of the reference (reference cluster/cluster.go):
instances wired with static full-mesh peers (each marking itself owner of
its own address), fast GLOBAL sync so gossip convergence shows in tens of
milliseconds (cluster.go:84), and accessors by index or at random. All
servers share one asyncio loop running on a dedicated thread, so callers
drive them with plain blocking gRPC clients from the main thread — real
sockets, discovery bypassed.

Each node's backend is `backend_factory()` when one is given, else the
port's `make_backend(conf)` on the CUDA device; tests pass a factory of
`TorchBackend(..., device="cpu")`. `env` (GUBER_* variables) configures
every node as the daemon would be (config_from_env), over the harness's
one default, a 50 ms GLOBAL sync (GUBER_GLOBAL_SYNC_WAIT_MS); the harness
then sets only the addresses and the static peers.
"""

from __future__ import annotations

import asyncio
import random
import threading
from typing import Callable, List, Optional, Sequence

from gubernator_tpu_torch.serve.config import ServerConfig, config_from_env

#: the harness's defaults under `env`: fast gossip, so GLOBAL convergence
#: shows in tens of milliseconds (reference cluster.go:84)
HARNESS_ENV = {"GUBER_GLOBAL_SYNC_WAIT_MS": "50"}
from gubernator_tpu_torch.serve.server import Server


class LocalCluster:
    def __init__(
        self,
        addresses: Sequence[str],
        backend_factory: Optional[Callable[[], object]] = None,
        http_addresses: Optional[Sequence[str]] = None,
        env: Optional[dict] = None,
    ):
        """`http_addresses` (parallel to `addresses`) additionally serves
        each node's HTTP JSON gateway — the default is gRPC-only like the
        reference's harness (cluster.go).

        A backend_factory must size its ladder to the config's
        GUBER_DEVICE_BATCH_LIMIT (core.engine.buckets_for_limit)."""
        self.addresses = list(addresses)
        self.http_addresses = (
            list(http_addresses) if http_addresses else [""] * len(addresses)
        )
        if len(self.http_addresses) != len(self.addresses):
            # zip would silently truncate and leave nodes never started
            raise ValueError(
                f"http_addresses ({len(self.http_addresses)}) must match "
                f"addresses ({len(self.addresses)})"
            )
        self._env = dict(HARNESS_ENV, **(env or {}))
        self.servers: List[Server] = []
        self._backend_factory = backend_factory
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: float = 90.0) -> None:
        started = threading.Event()
        failure: list = []

        def runner():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self._start_all())
            except Exception as e:
                failure.append(e)
                # tear down any partially-started servers and mark the
                # loop dead so a later stop() cannot schedule onto it
                # and hang (reference cluster_test.go covers exactly the
                # bad-address startup-failure path)
                try:
                    loop.run_until_complete(self._stop_all())
                except Exception:
                    pass
                loop.close()
                self._loop = None
                self.servers = []
                started.set()
                return
            started.set()
            loop.run_forever()

        self._thread = threading.Thread(
            target=runner, name="guber-cluster", daemon=True
        )
        self._thread.start()
        if not started.wait(timeout):
            raise TimeoutError("cluster failed to start in time")
        if failure:
            raise failure[0]

    def _conf(self, addr: str, http_addr: str) -> ServerConfig:
        conf = config_from_env(dict(self._env))
        conf.grpc_address = addr
        conf.http_address = http_addr
        conf.advertise_address = addr
        # static full-mesh peers; self marked owner (cluster.go:36-46)
        conf.peers = list(self.addresses)
        return conf

    async def _start_all(self) -> None:
        for addr, http_addr in zip(self.addresses, self.http_addresses):
            backend = (
                self._backend_factory()
                if self._backend_factory is not None
                else None
            )
            server = Server(self._conf(addr, http_addr), backend=backend)
            await server.start()
            self.servers.append(server)

    async def _stop_all(self) -> None:
        for s in self.servers:
            await s.stop()

    def stop(self) -> None:
        loop = self._loop
        if (
            loop is None
            or loop.is_closed()
            or self._thread is None
            or not self._thread.is_alive()
        ):
            # never started, or start failed (runner already cleaned up)
            self._loop = None
            self.servers = []
            return
        fut = asyncio.run_coroutine_threadsafe(self._stop_all(), loop)
        fut.result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        self._thread.join(timeout=10)
        self._loop = None
        self.servers = []

    # -- accessors (cluster.go:56-68) ---------------------------------------

    def get_peer(self) -> str:
        """A random node's address."""
        return random.choice(self.addresses)

    def peer_at(self, i: int) -> str:
        return self.addresses[i]

    def instance_at(self, i: int):
        return self.servers[i].instance

    def run(self, coro, timeout: float = 30.0):
        """Run a coroutine on the cluster loop from the calling thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout=timeout)
