"""Conversions between wire protobuf messages and the internal dataclasses
(the port's copy of gubernator_tpu/api/convert.py)."""

from __future__ import annotations

from gubernator_tpu_torch.api.proto.gen import gubernator_pb2
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    ChainLevel,
    RateLimitReq,
    RateLimitResp,
    Status,
)


def req_from_pb(pb) -> RateLimitReq:
    return RateLimitReq(
        name=pb.name,
        unique_key=pb.unique_key,
        hits=pb.hits,
        limit=pb.limit,
        duration=pb.duration,
        algorithm=Algorithm(pb.algorithm),
        behavior=Behavior(pb.behavior),
        chain=[
            ChainLevel(
                unique_key=lv.unique_key,
                limit=lv.limit,
                duration=lv.duration,
            )
            for lv in pb.chain
        ],
    )


def req_to_pb(r: RateLimitReq):
    pb = gubernator_pb2.RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=r.hits,
        limit=r.limit,
        duration=r.duration,
        algorithm=int(r.algorithm),
        behavior=int(r.behavior),
    )
    for lv in r.chain:
        pb.chain.add(
            unique_key=lv.unique_key,
            limit=lv.limit,
            duration=lv.duration,
        )
    return pb


def resp_from_pb(pb) -> RateLimitResp:
    return RateLimitResp(
        status=Status(pb.status),
        limit=pb.limit,
        remaining=pb.remaining,
        reset_time=pb.reset_time,
        error=pb.error,
        metadata=dict(pb.metadata),
    )


def resp_to_pb(r: RateLimitResp):
    pb = gubernator_pb2.RateLimitResp(
        status=int(r.status),
        limit=r.limit,
        remaining=r.remaining,
        reset_time=r.reset_time,
        error=r.error,
    )
    for k, v in r.metadata.items():
        pb.metadata[k] = v
    return pb
