"""Vendored minimal etcd v3 client over grpcio.

The reference registers membership through etcd clientv3
(reference etcd.go:36-316: lease grant + keepalive, prefix put/watch).
This image has no `etcd3` python package, so the repo vendors the thin
slice it needs — KV Put/Range/DeleteRange, Lease Grant/Revoke/KeepAlive,
Watch — over the already-present grpcio stack and the vendored etcd
protos (api/proto/etcd_rpc.proto, field-number-exact with real etcd).

The public surface is deliberately etcd3-library-compatible (the subset
serve/discovery.py's EtcdPool consumes: `lease()`, `put()`,
`get_prefix()`, `watch_prefix()`, `delete()`), so the pool runs
identically on either implementation and the discovery contract tests
(tests/_discovery_contract.py) pin both from each side.

Sync client (discovery drives it from worker threads via to_thread,
matching the etcd3 library's model).

The port's copy of gubernator_tpu/serve/etcd_client.py with its imports
rewritten, on the port's copy of the etcd protos (api/proto/gen/, the
serialized descriptors byte for byte); the file references above are
the reference package's.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import grpc

from gubernator_tpu_torch.api.proto.gen import etcd_rpc_pb2 as rpc

log = logging.getLogger("gubernator_tpu_torch.etcd")

_KV = "etcdserverpb.KV"
_LEASE = "etcdserverpb.Lease"
_WATCH = "etcdserverpb.Watch"


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd prefix query convention: range_end = prefix with its last
    byte incremented (0xff bytes roll into the next position; an
    all-0xff prefix scans to the end of keyspace, '\\0')."""
    end = bytearray(prefix)
    while end:
        if end[-1] < 0xFF:
            end[-1] += 1
            return bytes(end)
        end.pop()
    return b"\0"


class VendoredLease:
    """Mirror of etcd3.Lease: holds the ID, refreshes via one-shot
    keepalive calls."""

    def __init__(self, client: "VendoredEtcdClient", lease_id: int,
                 ttl: int):
        self._client = client
        self.id = lease_id
        self.ttl = ttl

    def refresh(self) -> None:
        resp = self._client._keepalive_once(self.id)
        if resp.TTL <= 0:
            raise RuntimeError(f"lease {self.id} expired (TTL<=0)")

    def revoke(self) -> None:
        self._client._lease_revoke(self.id)


class _KVMeta:
    """Shape-compatible stand-in for etcd3's KVMetadata (the pool only
    reads .key)."""

    def __init__(self, kv):
        self.key = kv.key
        self.create_revision = kv.create_revision
        self.mod_revision = kv.mod_revision
        self.version = kv.version
        self.lease_id = kv.lease


class VendoredEtcdClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 2379,
        ca_cert: Optional[str] = None,
        cert_cert: Optional[str] = None,
        cert_key: Optional[str] = None,
        timeout: float = 10.0,
    ):
        target = f"{host}:{port}"
        if ca_cert or cert_cert:
            def read(path):
                with open(path, "rb") as f:
                    return f.read()

            creds = grpc.ssl_channel_credentials(
                root_certificates=read(ca_cert) if ca_cert else None,
                private_key=read(cert_key) if cert_key else None,
                certificate_chain=read(cert_cert) if cert_cert else None,
            )
            self._chan = grpc.secure_channel(target, creds)
        else:
            self._chan = grpc.insecure_channel(target)
        self._timeout = timeout
        u = self._chan.unary_unary
        self._put = u(
            f"/{_KV}/Put",
            request_serializer=rpc.PutRequest.SerializeToString,
            response_deserializer=rpc.PutResponse.FromString,
        )
        self._range = u(
            f"/{_KV}/Range",
            request_serializer=rpc.RangeRequest.SerializeToString,
            response_deserializer=rpc.RangeResponse.FromString,
        )
        self._delete_range = u(
            f"/{_KV}/DeleteRange",
            request_serializer=rpc.DeleteRangeRequest.SerializeToString,
            response_deserializer=rpc.DeleteRangeResponse.FromString,
        )
        self._lease_grant = u(
            f"/{_LEASE}/LeaseGrant",
            request_serializer=rpc.LeaseGrantRequest.SerializeToString,
            response_deserializer=rpc.LeaseGrantResponse.FromString,
        )
        self._lease_revoke_rpc = u(
            f"/{_LEASE}/LeaseRevoke",
            request_serializer=rpc.LeaseRevokeRequest.SerializeToString,
            response_deserializer=rpc.LeaseRevokeResponse.FromString,
        )
        self._keepalive_stream = self._chan.stream_stream(
            f"/{_LEASE}/LeaseKeepAlive",
            request_serializer=rpc.LeaseKeepAliveRequest.SerializeToString,
            response_deserializer=rpc.LeaseKeepAliveResponse.FromString,
        )
        self._watch_stream = self._chan.stream_stream(
            f"/{_WATCH}/Watch",
            request_serializer=rpc.WatchRequest.SerializeToString,
            response_deserializer=rpc.WatchResponse.FromString,
        )

    # -- etcd3-compatible surface ------------------------------------------

    def lease(self, ttl: int) -> VendoredLease:
        resp = self._lease_grant(
            rpc.LeaseGrantRequest(TTL=ttl), timeout=self._timeout
        )
        if resp.error:
            raise RuntimeError(f"lease grant failed: {resp.error}")
        return VendoredLease(self, resp.ID, resp.TTL)

    def put(self, key, value, lease: Optional[VendoredLease] = None):
        self._put(
            rpc.PutRequest(
                key=_b(key),
                value=_b(value),
                lease=lease.id if lease is not None else 0,
            ),
            timeout=self._timeout,
        )

    def get_prefix(self, prefix) -> List[Tuple[bytes, _KVMeta]]:
        p = _b(prefix)
        resp = self._range(
            rpc.RangeRequest(key=p, range_end=prefix_range_end(p)),
            timeout=self._timeout,
        )
        return [(kv.value, _KVMeta(kv)) for kv in resp.kvs]

    def delete(self, key) -> bool:
        resp = self._delete_range(
            rpc.DeleteRangeRequest(key=_b(key)), timeout=self._timeout
        )
        return resp.deleted > 0

    def watch_prefix(self, prefix):
        """(events_iterator, cancel) — the iterator yields one object per
        etcd event and blocks between events; cancel() unblocks and ends
        it (the etcd3 library contract the pool consumes)."""
        p = _b(prefix)
        req_q: "queue.Queue" = queue.Queue()
        req_q.put(
            rpc.WatchRequest(
                create_request=rpc.WatchCreateRequest(
                    key=p, range_end=prefix_range_end(p)
                )
            )
        )
        done = threading.Event()

        def requests():
            while not done.is_set():
                try:
                    item = req_q.get(timeout=0.5)
                except queue.Empty:
                    continue
                if item is None:
                    return
                yield item

        call = self._watch_stream(requests())

        def events() -> Iterator[object]:
            try:
                for resp in call:
                    if resp.canceled:
                        return
                    for ev in resp.events:
                        yield ev
            except grpc.RpcError as e:
                if e.code() in (
                    grpc.StatusCode.CANCELLED,
                    grpc.StatusCode.UNAVAILABLE,
                ) and done.is_set():
                    return  # cancel() path: not an error
                raise

        def cancel():
            done.set()
            req_q.put(None)
            call.cancel()

        return events(), cancel

    # -- internals ----------------------------------------------------------

    def _keepalive_once(self, lease_id: int):
        """One-shot keepalive: open the stream, send one request, read
        one response. The pool refreshes at TTL/3, so a persistent
        stream buys nothing and one-shot keeps failure handling local."""
        call = self._keepalive_stream(
            iter([rpc.LeaseKeepAliveRequest(ID=lease_id)]),
            timeout=self._timeout,
        )
        for resp in call:
            return resp
        raise RuntimeError("keepalive stream closed without a response")

    def _lease_revoke(self, lease_id: int) -> None:
        self._lease_revoke_rpc(
            rpc.LeaseRevokeRequest(ID=lease_id), timeout=self._timeout
        )

    def close(self) -> None:
        self._chan.close()


def _b(v) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)
