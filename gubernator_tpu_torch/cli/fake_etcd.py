"""In-tree fake etcd v3 server over REAL gRPC.

Implements exactly the KV/Lease/Watch slice the vendored client
(serve/etcd_client.py) speaks, using the same vendored etcd protos — so
the client's live wire path (streams included) executes against a real
grpc server in-process. Parity with real etcd rests on the protos'
field-number fidelity (api/proto/etcd_rpc.proto); the same test suite
runs against a live etcd when GUBER_TEST_ETCD names an endpoint.

Deliberately tiny: single-tenant, no auth, no transactions, no
compaction; lease expiry is driven by revoke_lease() rather than a
clock, so tests control the failure injection.

The port's copy of the reference package's test double
(tests/_fake_etcd.py), on the port's etcd protos, so that the chaos
soak's rolling mode (cli/chaos_soak.py) and a hand-run deployment have
an etcd on a host without the JAX package. As a program it serves until
SIGINT or SIGTERM and prints its address:

    python -m gubernator_tpu_torch.cli.fake_etcd [--port N]

then boot daemons with GUBER_ETCD_ENDPOINTS=127.0.0.1:<port>.
"""

from __future__ import annotations

import argparse
import queue
import signal
import threading
from concurrent import futures
from typing import Dict, List, Tuple

import grpc

from gubernator_tpu_torch.api.proto.gen import etcd_mvcc_pb2 as mvcc
from gubernator_tpu_torch.api.proto.gen import etcd_rpc_pb2 as rpc


class FakeEtcd:
    def __init__(self, port: int = 0):
        self._lock = threading.Lock()
        self._rev = 1
        self._kv: Dict[bytes, Tuple[bytes, int, int, int, int]] = {}
        # key -> (value, lease, create_rev, mod_rev, version)
        self._leases: Dict[int, int] = {}  # id -> ttl (alive)
        self._next_lease = 1000
        self._watches: List[Tuple[bytes, bytes, "queue.Queue"]] = []
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._register_services()
        self.port = self.server.add_insecure_port(f"127.0.0.1:{port}")

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop(grace=0.2)

    # -- test hooks ---------------------------------------------------------

    def revoke_lease(self, lease_id: int) -> None:
        """Simulate lease expiry: drop the lease and its keys (with
        DELETE watch events), like real etcd at TTL expiry."""
        with self._lock:
            self._leases.pop(lease_id, None)
            dead = [
                k for k, (_v, ls, *_rest) in self._kv.items()
                if ls == lease_id
            ]
            for k in dead:
                self._delete_locked(k)

    def lease_ids(self):
        with self._lock:
            return set(self._leases)

    def keys(self):
        with self._lock:
            return sorted(self._kv)

    # -- internals ----------------------------------------------------------

    def _kv_proto(self, key: bytes) -> mvcc.KeyValue:
        v, ls, cr, mr, ver = self._kv[key]
        return mvcc.KeyValue(
            key=key, value=v, lease=ls, create_revision=cr,
            mod_revision=mr, version=ver,
        )

    def _notify_locked(self, ev: mvcc.Event) -> None:
        for start, end, q in self._watches:
            if start <= ev.kv.key < end:
                q.put(ev)

    def _delete_locked(self, key: bytes) -> None:
        kv = self._kv_proto(key)
        del self._kv[key]
        self._rev += 1
        self._notify_locked(
            mvcc.Event(type=mvcc.Event.DELETE, kv=mvcc.KeyValue(key=kv.key))
        )

    # -- RPC handlers -------------------------------------------------------

    def _Put(self, req: rpc.PutRequest, ctx) -> rpc.PutResponse:
        with self._lock:
            if req.lease and req.lease not in self._leases:
                ctx.abort(grpc.StatusCode.NOT_FOUND, "lease not found")
            old = self._kv.get(req.key)
            self._rev += 1
            if old is None:
                self._kv[req.key] = (req.value, req.lease, self._rev,
                                     self._rev, 1)
            else:
                self._kv[req.key] = (req.value, req.lease, old[2],
                                     self._rev, old[4] + 1)
            self._notify_locked(
                mvcc.Event(type=mvcc.Event.PUT, kv=self._kv_proto(req.key))
            )
            return rpc.PutResponse(
                header=rpc.ResponseHeader(revision=self._rev)
            )

    def _Range(self, req: rpc.RangeRequest, ctx) -> rpc.RangeResponse:
        with self._lock:
            if req.range_end:
                keys = [
                    k for k in sorted(self._kv)
                    if req.key <= k < req.range_end
                ]
            else:
                keys = [req.key] if req.key in self._kv else []
            kvs = [self._kv_proto(k) for k in keys]
            return rpc.RangeResponse(
                header=rpc.ResponseHeader(revision=self._rev),
                kvs=kvs, count=len(kvs),
            )

    def _DeleteRange(self, req, ctx) -> rpc.DeleteRangeResponse:
        with self._lock:
            if req.range_end:
                keys = [
                    k for k in sorted(self._kv)
                    if req.key <= k < req.range_end
                ]
            else:
                keys = [req.key] if req.key in self._kv else []
            for k in keys:
                self._delete_locked(k)
            return rpc.DeleteRangeResponse(
                header=rpc.ResponseHeader(revision=self._rev),
                deleted=len(keys),
            )

    def _LeaseGrant(self, req, ctx) -> rpc.LeaseGrantResponse:
        with self._lock:
            self._next_lease += 1
            self._leases[self._next_lease] = req.TTL
            return rpc.LeaseGrantResponse(ID=self._next_lease, TTL=req.TTL)

    def _LeaseRevoke(self, req, ctx) -> rpc.LeaseRevokeResponse:
        self.revoke_lease(req.ID)
        return rpc.LeaseRevokeResponse()

    def _LeaseKeepAlive(self, request_iterator, ctx):
        for req in request_iterator:
            with self._lock:
                ttl = self._leases.get(req.ID, 0)
            # real etcd answers TTL=0 for an expired/unknown lease —
            # the signal the pool's refresh turns into a re-register
            yield rpc.LeaseKeepAliveResponse(ID=req.ID, TTL=ttl)

    def _Watch(self, request_iterator, ctx):
        q: "queue.Queue" = queue.Queue()
        created = threading.Event()
        stop = threading.Event()

        def reader():
            try:
                for req in request_iterator:
                    which = req.WhichOneof("request_union")
                    if which == "create_request":
                        cr = req.create_request
                        with self._lock:
                            self._watches.append(
                                (cr.key, cr.range_end or cr.key + b"\0", q)
                            )
                        created.set()
                    elif which == "cancel_request":
                        stop.set()
                        q.put(None)
            except Exception:
                pass
            finally:
                stop.set()
                q.put(None)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        created.wait(timeout=5)
        yield rpc.WatchResponse(created=True, watch_id=1)
        try:
            while not stop.is_set():
                ev = q.get()
                if ev is None:
                    break
                yield rpc.WatchResponse(watch_id=1, events=[ev])
        finally:
            with self._lock:
                self._watches = [
                    w for w in self._watches if w[2] is not q
                ]

    def _register_services(self):
        def unary(fn, req_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )

        kv = {
            "Put": unary(self._Put, rpc.PutRequest),
            "Range": unary(self._Range, rpc.RangeRequest),
            "DeleteRange": unary(self._DeleteRange, rpc.DeleteRangeRequest),
        }
        lease = {
            "LeaseGrant": unary(self._LeaseGrant, rpc.LeaseGrantRequest),
            "LeaseRevoke": unary(self._LeaseRevoke, rpc.LeaseRevokeRequest),
            "LeaseKeepAlive": grpc.stream_stream_rpc_method_handler(
                self._LeaseKeepAlive,
                request_deserializer=rpc.LeaseKeepAliveRequest.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
        }
        watch = {
            "Watch": grpc.stream_stream_rpc_method_handler(
                self._Watch,
                request_deserializer=rpc.WatchRequest.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
        }
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("etcdserverpb.KV", kv),
            grpc.method_handlers_generic_handler("etcdserverpb.Lease", lease),
            grpc.method_handlers_generic_handler("etcdserverpb.Watch", watch),
        ))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="in-memory etcd v3 (KV, Lease, Watch) over gRPC"
    )
    ap.add_argument("--port", type=int, default=0,
                    help="port on 127.0.0.1 (0: any free port)")
    args = ap.parse_args(argv)
    etcd = FakeEtcd(args.port).start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(f"fake etcd listening on 127.0.0.1:{etcd.port}", flush=True)
    stop.wait()
    etcd.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
