"""Python client for gubernator-tpu (and wire-compatible with the
reference server); the port's copy of gubernator_tpu/client.py, so code
that must not import the JAX package (chip_smoke.py) has a client.

Covers the reference's Go client helpers (reference client.go) and Python
client package (reference python/gubernator/__init__.py): blocking and
asyncio flavors, duration constants, a reset-time sleeper, and peer/string
helpers for load generation.
"""

from __future__ import annotations

import random
import string
import time
from typing import List, Optional, Sequence

import grpc

from gubernator_tpu_torch.api import convert
from gubernator_tpu_torch.api.grpc_glue import V1Stub
from gubernator_tpu_torch.api.proto.gen import gubernator_pb2
from gubernator_tpu_torch.api.types import (
    HealthCheckResp,
    MILLISECOND,
    MINUTE,
    RateLimitReq,
    RateLimitResp,
    SECOND,
)
from gubernator_tpu_torch.endpoints import parse_endpoint

__all__ = [
    "V1Client",
    "AsyncV1Client",
    "sleep_until_reset",
    "random_peer",
    "random_string",
    "MILLISECOND",
    "SECOND",
    "MINUTE",
]


def _grpc_target(endpoint: str) -> str:
    """Validate a client endpoint through the shared parser: 'host:port'
    (IPv4 or hostname) split on the last colon; an IPv6 literal is
    refused loudly here instead of misparsing downstream."""
    kind, addr = parse_endpoint(endpoint, "client endpoint")
    if kind != "tcp":
        raise ValueError(
            f"client endpoint {endpoint!r} is a unix path; the gRPC "
            f"client needs 'host:port' (unix sockets are the GEB "
            f"client's job, gubernator_tpu_torch.client_geb)"
        )
    host, port = addr
    return f"{host}:{port}"


class V1Client:
    """Blocking client over an insecure channel (reference client.go:38-49)."""

    def __init__(self, endpoint: str = "127.0.0.1:81"):
        self.channel = grpc.insecure_channel(_grpc_target(endpoint))
        self.stub = V1Stub(self.channel)

    def get_rate_limits(
        self, requests: Sequence[RateLimitReq], timeout: Optional[float] = None
    ) -> List[RateLimitResp]:
        pb = gubernator_pb2.GetRateLimitsReq(
            requests=[convert.req_to_pb(r) for r in requests]
        )
        resp = self.stub.GetRateLimits(pb, timeout=timeout)
        return [convert.resp_from_pb(r) for r in resp.responses]

    def health_check(self, timeout: Optional[float] = None) -> HealthCheckResp:
        resp = self.stub.HealthCheck(
            gubernator_pb2.HealthCheckReq(), timeout=timeout
        )
        return HealthCheckResp(
            status=resp.status, message=resp.message, peer_count=resp.peer_count
        )

    def close(self) -> None:
        self.channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class AsyncV1Client:
    """asyncio flavor of V1Client."""

    def __init__(self, endpoint: str = "127.0.0.1:81"):
        self.channel = grpc.aio.insecure_channel(_grpc_target(endpoint))
        self.stub = V1Stub(self.channel)

    async def get_rate_limits(
        self, requests: Sequence[RateLimitReq], timeout: Optional[float] = None
    ) -> List[RateLimitResp]:
        pb = gubernator_pb2.GetRateLimitsReq(
            requests=[convert.req_to_pb(r) for r in requests]
        )
        resp = await self.stub.GetRateLimits(pb, timeout=timeout)
        return [convert.resp_from_pb(r) for r in resp.responses]

    async def health_check(
        self, timeout: Optional[float] = None
    ) -> HealthCheckResp:
        resp = await self.stub.HealthCheck(
            gubernator_pb2.HealthCheckReq(), timeout=timeout
        )
        return HealthCheckResp(
            status=resp.status, message=resp.message, peer_count=resp.peer_count
        )

    async def close(self) -> None:
        await self.channel.close()



def sleep_until_reset(resp: RateLimitResp) -> None:
    """Sleep until the limit's reset time (python client's helper)."""
    delta = resp.reset_time / 1000.0 - time.time()
    if delta > 0:
        time.sleep(delta)


def random_peer(peers: Sequence[str]) -> str:
    return random.choice(list(peers))


def random_string(prefix: str = "", n: int = 10) -> str:
    return prefix + "".join(
        random.choices(string.ascii_letters + string.digits, k=n)
    )
