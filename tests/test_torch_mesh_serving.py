"""The port's mesh backend through the full serving stack on the CPU: the
cases of tests/test_mesh_serving.py, an 8-shard MeshBackend (the 8 shards
on the one CPU) behind a real gRPC server of the port's LocalCluster
(instance, batcher, warmup), driven by the port's V1Client.

Covers what GUBER_BACKEND=mesh wires up: the warmup runs every sub-batch
rung through the public decide path, the pipelined submit/wait split runs
under the batcher, GLOBAL keys broadcast and install on every shard, and
the oracle's transitions hold over the wire.
"""

import time

import pytest

from _util import free_ports
from gubernator_tpu_torch.api.types import Algorithm, Behavior, RateLimitReq, Status
from gubernator_tpu_torch.client import V1Client
from gubernator_tpu_torch.cluster import LocalCluster
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import MeshBackend


@pytest.fixture(scope="module")
def mesh_cluster():
    backends = []

    def factory():
        # a tiny ladder and store: the warmup walks a handful of rungs
        backends.append(MeshBackend(StoreConfig(rows=16, slots=256), devices=["cpu"] * 8,
                                    buckets=(64,)))
        return backends[-1]

    cluster = LocalCluster([f"127.0.0.1:{p}" for p in free_ports(1)], backend_factory=factory)
    cluster.start()
    assert backends[0].engine.n == 8
    yield cluster
    cluster.stop()


def test_mesh_backend_served_transitions(mesh_cluster):
    """Token 2 -> 1 -> 0 -> OVER and a leaky drain, decided by the sharded
    engine behind real gRPC."""
    with V1Client(mesh_cluster.get_peer()) as client:
        seq = []
        for _ in range(4):
            rl = client.get_rate_limits(
                [RateLimitReq(name="mesh-serve", unique_key="tok", hits=1, limit=3,
                              duration=60_000)],
                timeout=20,
            )[0]
            seq.append((rl.status, rl.remaining))
        assert seq == [
            (Status.UNDER_LIMIT, 2), (Status.UNDER_LIMIT, 1),
            (Status.UNDER_LIMIT, 0), (Status.OVER_LIMIT, 0),
        ], seq
        leaky = client.get_rate_limits(
            [RateLimitReq(name="mesh-serve", unique_key="lk", hits=2, limit=4,
                          duration=2_000, algorithm=Algorithm.LEAKY_BUCKET)],
            timeout=20,
        )[0]
        assert (leaky.status, leaky.remaining) == (Status.UNDER_LIMIT, 2)


def test_mesh_backend_served_global(mesh_cluster):
    """GLOBAL on the mesh backend: the one node owns every key, so a GLOBAL
    decide charges locally and queues a broadcast whose replica install
    (update_globals through the batcher into the owner-masked installs)
    keeps the key's state consistent over repeated reads."""
    with V1Client(mesh_cluster.get_peer()) as client:
        def hit(hits):
            return client.get_rate_limits(
                [RateLimitReq(name="mesh-serve", unique_key="g", hits=hits, limit=5,
                              duration=60_000, behavior=Behavior.GLOBAL)],
                timeout=20,
            )[0]

        first = hit(1)
        assert (first.status, first.remaining) == (Status.UNDER_LIMIT, 4)
        time.sleep(0.3)  # let the broadcast loop run at least once
        second = hit(1)
        assert (second.status, second.remaining) == (Status.UNDER_LIMIT, 3)
        assert hit(0).remaining == 3
