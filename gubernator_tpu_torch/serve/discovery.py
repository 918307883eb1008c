"""Cluster membership discovery (the port of gubernator_tpu/serve/discovery.py).

Three pools, mirroring the reference's discovery layer:

- StaticPool — fixed peer list (the reference's GUBER_PEERS-style wiring
  and test-cluster path, cluster/cluster.go:36-46).
- EtcdPool — registers this node under `<prefix><advertise>` with a TTL
  lease + keepalive and watches the prefix for peer changes (reference
  etcd.go:36-316). Uses the etcd3 library when installed; otherwise
  falls back to the vendored grpcio client (serve/etcd_client.py), so
  etcd discovery works out of the box in this image.
- K8sPool — watches the Endpoints API filtered by a label selector and
  marks self by pod IP (reference kubernetes.go:56-157). Uses the
  kubernetes client when installed; otherwise falls back to the
  vendored REST client (serve/k8s_client.py), likewise working out of
  the box.

All pools push full `[]PeerInfo` snapshots through `on_update`, and the
instance rebuilds its ring (reference etcd.go:308-316 -> SetPeers).

The port's copy with its imports rewritten: the vendored clients are the
port's (serve/etcd_client.py on the port's etcd protos, serve/k8s_client.py),
so the port imports nothing of gubernator_tpu.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, List, Optional, Sequence

from gubernator_tpu_torch.api.types import PeerInfo

log = logging.getLogger("gubernator_tpu_torch.discovery")

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
        await self._push()

    async def update(self, peers: Sequence[str]) -> None:
        """Replace the static membership and push the change — the
        ring-change notification for embedders driving membership by
        hand (the etcd/k8s pools watch for theirs). A static-peers
        deployment scaling by config reload funnels through the same
        on_update -> Instance.set_peers -> rescale handoff path as a
        watched one (serve/rescale.py)."""
        self.peers = list(peers)
        await self._push()

    async def _push(self) -> None:
        await self.on_update(
            [
                PeerInfo(address=p, is_owner=(p == self.advertise))
                for p in self.peers
            ]
        )

    async def close(self) -> None:
        pass


class EtcdPool:
    """etcd-backed membership (lease TTL 30s + keepalive + prefix watch)."""

    LEASE_TTL_S = 30  # matches the reference's lease TTL (etcd.go:39)

    def __init__(
        self,
        endpoints: Sequence[str],
        prefix: str,
        advertise: str,
        on_update: OnUpdate,
        tls_cert: str = "",
        tls_key: str = "",
        tls_ca: str = "",
        client=None,
    ):
        """`client` injects a pre-built etcd3-compatible client (tests use
        fakes; production leaves it None). The TLS bundle mirrors the
        reference's GUBER_ETCD_TLS_* surface
        (cmd/gubernator/config.go:149-192): ca alone enables server
        verification; mutual TLS needs all three (python-etcd3 requires
        ca_cert with a client cert pair)."""
        if client is None:
            host, _, port = endpoints[0].rpartition(":")
            kwargs: dict = {}
            if tls_ca:
                kwargs["ca_cert"] = tls_ca
            if tls_cert or tls_key:
                if not (tls_cert and tls_key):
                    raise ValueError(
                        "etcd TLS requires both cert and key (got only one)"
                    )
                kwargs["cert_cert"] = tls_cert
                kwargs["cert_key"] = tls_key
            try:
                # prefer the etcd3 library when installed (the contract
                # tests pin the pool against it; pip install .[discovery])
                import etcd3

                client = etcd3.client(
                    host=host, port=int(port or 2379), **kwargs
                )
            except ImportError:
                # vendored minimal client over grpcio (serve/etcd_client):
                # same etcd3-shaped surface, no extra dependency
                from gubernator_tpu_torch.serve.etcd_client import (
                    VendoredEtcdClient,
                )

                client = VendoredEtcdClient(
                    host=host, port=int(port or 2379), **kwargs
                )
        self.client = client
        self.prefix = prefix
        self.advertise = advertise
        self.on_update = on_update
        self._lease = None
        self._tasks: list = []
        self._closing = False
        # last membership actually delivered (sorted addresses):
        # consecutive identical snapshots are not re-pushed — the
        # watch-start re-sync (see _consume_watch) usually confirms
        # what the initial push already delivered, and every push
        # rebuilds the instance's ring
        self._last_pushed: Optional[list] = None

    async def start(self) -> None:
        await asyncio.to_thread(self._register)
        await self._push_peers()
        self._tasks = [
            asyncio.ensure_future(self._keepalive_loop()),
            asyncio.ensure_future(self._watch_loop()),
        ]

    def _register(self) -> None:
        self._lease = self.client.lease(self.LEASE_TTL_S)
        self.client.put(
            self.prefix + self.advertise, self.advertise, lease=self._lease
        )

    async def _keepalive_loop(self) -> None:
        # refresh at 1/3 TTL; on lease loss re-register (etcd.go:247-301)
        while True:
            await asyncio.sleep(self.LEASE_TTL_S / 3)
            try:
                await asyncio.to_thread(self._lease.refresh)
            except Exception as e:
                log.warning("etcd lease lost (%s); re-registering", e)
                try:
                    await asyncio.to_thread(self._register)
                except Exception as e2:
                    log.error("etcd re-register failed: %s", e2)

    async def _watch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        # stop the restart cycle once close() begins: restarting a watch
        # after close cancelled the current one would strand a worker
        # thread blocked in the new watch's iterator (no cancel handle
        # left pointing at it), which wedges loop shutdown
        while not self._closing:
            try:
                # the watch iterator blocks between events, so it must be
                # consumed on a worker thread — never on the serving loop
                await asyncio.to_thread(self._consume_watch, loop)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self._closing:
                    break
                log.error("etcd watch error: %s; retrying", e)
                await asyncio.sleep(1)

    def _consume_watch(self, loop) -> None:
        events, cancel = self.client.watch_prefix(self.prefix)
        self._cancel_watch = cancel
        # re-sync AFTER the watch is live: a peer that registered
        # between start()'s initial _push_peers and this point emitted
        # its event before anyone was watching, and nothing else ever
        # re-pushes — the node would sit at a stale peer count until
        # the NEXT membership change (observed as test_compose_topology
        # flaking at peerCount 1 under full-suite load, where the
        # register->watch gap stretches to seconds)
        asyncio.run_coroutine_threadsafe(self._push_peers(), loop).result()
        for _ in events:
            asyncio.run_coroutine_threadsafe(self._push_peers(), loop).result()

    async def _push_peers(self) -> None:
        kvs = await asyncio.to_thread(
            lambda: list(self.client.get_prefix(self.prefix))
        )
        peers = [
            PeerInfo(
                address=v.decode(), is_owner=(v.decode() == self.advertise)
            )
            for v, _ in kvs
        ]
        key = sorted(p.address for p in peers)
        if key == self._last_pushed:
            return
        self._last_pushed = key
        await self.on_update(peers)

    async def close(self) -> None:
        # mark closing BEFORE cancelling: _watch_loop must not restart
        # the watch after its current consume unblocks (both run on this
        # loop, so the flag is visible before any restart can interleave)
        self._closing = True
        # cancel the blocking watch FIRST or its worker thread outlives
        # the pool (the iterator blocks between events)
        cancel = getattr(self, "_cancel_watch", None)
        if cancel is not None:
            try:
                cancel()
            except Exception:
                pass
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        try:
            await asyncio.to_thread(
                self.client.delete, self.prefix + self.advertise
            )
        except Exception:
            pass


class K8sPool:
    """Kubernetes Endpoints watcher."""

    def __init__(
        self,
        namespace: str,
        selector: str,
        pod_ip: str,
        pod_port: str,
        on_update: OnUpdate,
        api=None,
        watch=None,
    ):
        """`api`/`watch` inject pre-built client objects (tests use
        fakes); production loads the in-cluster config. Inject both or
        neither — a partial injection would silently rebuild the other
        from the real cluster."""
        if (api is None) != (watch is None):
            raise ValueError("inject both api and watch, or neither")
        if api is None:
            try:
                # prefer the kubernetes library when installed (contract
                # tests pin the pool against it; pip install .[discovery])
                import kubernetes

                kubernetes.config.load_incluster_config()
                api = kubernetes.client.CoreV1Api()
                watch = kubernetes.watch.Watch()
            except ImportError:
                # vendored minimal client over the plain REST API
                # (serve/k8s_client): same surface, no dependency
                from gubernator_tpu_torch.serve.k8s_client import (
                    VendoredK8sApi,
                    VendoredK8sWatch,
                )

                api = VendoredK8sApi()  # in-cluster config
                watch = VendoredK8sWatch()
        self.api = api
        self.watch = watch
        self.namespace = namespace
        self.selector = selector
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.on_update = on_update
        self._task = None
        self._closing = False

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._watch_loop())

    async def _watch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        # same no-restart-after-close guard as EtcdPool._watch_loop: a
        # watch restarted mid-teardown opens a fresh stream nothing will
        # ever stop
        while not self._closing:
            try:
                # blocking HTTP watch stream consumed on a worker thread
                await asyncio.to_thread(self._consume_stream, loop)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self._closing:
                    break
                log.error("k8s watch error: %s; retrying", e)
                await asyncio.sleep(1)

    def _consume_stream(self, loop) -> None:
        stream = self.watch.stream(
            self.api.list_namespaced_endpoints,
            self.namespace,
            label_selector=self.selector,
        )
        for event in stream:
            asyncio.run_coroutine_threadsafe(
                self._push(event["object"]), loop
            ).result()

    async def _push(self, endpoints) -> None:
        peers = []
        for subset in endpoints.subsets or []:
            for addr in subset.addresses or []:
                address = f"{addr.ip}:{self.pod_port}"
                peers.append(
                    PeerInfo(
                        address=address, is_owner=(addr.ip == self.pod_ip)
                    )
                )
        await self.on_update(peers)

    async def close(self) -> None:
        self._closing = True
        # stop the blocking HTTP watch FIRST or its worker thread stays
        # in the long-poll and later calls into a dead event loop (same
        # invariant as EtcdPool.close)
        stop = getattr(self.watch, "stop", None)
        if stop is not None:
            try:
                stop()
            except Exception:
                pass
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
