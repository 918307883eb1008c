"""The port's vendored etcd client (serve/etcd_client.py) and EtcdPool over
real gRPC: the seven cases of tests/test_etcd_vendored.py, each run with
the JAX package's client and the port's against the same fake, with the
same results asserted of both. Each case runs twice: against the JAX
package's fake (tests/_fake_etcd.py) and against the port's
(cli/fake_etcd.py), so each package's client also meets the other's
server. Plus both packages' etcd pb2 copies in one process: one
descriptor, one wire.
"""

import asyncio
import os
import threading
import time

import pytest

from gubernator_tpu.serve import etcd_client as jax_etcd
from gubernator_tpu_torch.cli import fake_etcd as torch_fake
from gubernator_tpu_torch.serve import etcd_client

import _fake_etcd as jax_fake

REAL_ETCD = os.environ.get("GUBER_TEST_ETCD", "")
CLIENTS = {"jax": jax_etcd, "torch": etcd_client}


@pytest.fixture(params=["jax_fake", "torch_fake"])
def make_fake(request):
    """A factory of started fakes, all stopped at teardown."""
    cls = {"jax_fake": jax_fake.FakeEtcd, "torch_fake": torch_fake.FakeEtcd}[
        request.param
    ]
    started = []

    def make():
        srv = cls().start()
        started.append(srv)
        return srv

    yield make
    for srv in started:
        srv.stop()


def each_client(make_fake, scenario):
    """`scenario(client, fake, client_module)` for each package's client,
    each on a fresh fake; the results by package name."""
    out = {}
    for name, mod in CLIENTS.items():
        fake = make_fake()
        c = mod.VendoredEtcdClient(host="127.0.0.1", port=fake.port)
        try:
            out[name] = scenario(c, fake, mod)
        finally:
            c.close()
    return out


def test_prefix_range_end_convention():
    for fn in (etcd_client.prefix_range_end, jax_etcd.prefix_range_end):
        assert fn(b"/guber/") == b"/guber0"
        assert fn(b"a\xff") == b"b"
        assert fn(b"\xff\xff") == b"\0"
        assert fn(b"") == b"\0"


def test_put_get_delete_roundtrip(make_fake):
    def scenario(client, fake, mod):
        client.put("/t/a", "A")
        client.put("/t/b", b"B")
        client.put("/u/other", "X")
        got = client.get_prefix("/t/")
        values = sorted(v for v, _m in got)
        keys = sorted(m.key for _v, m in got)
        deleted = (client.delete("/t/a"), client.delete("/t/a"))
        rest = [v for v, _m in client.get_prefix("/t/")]
        return values, keys, deleted, rest, fake.keys()

    out = each_client(make_fake, scenario)
    assert out["torch"] == out["jax"] == (
        [b"A", b"B"], [b"/t/a", b"/t/b"], (True, False), [b"B"],
        [b"/t/b", b"/u/other"],
    )


def test_lease_lifecycle_and_keepalive(make_fake):
    def scenario(client, fake, mod):
        lease = client.lease(30)
        assert lease.id in fake.lease_ids()
        client.put("/l/me", "me", lease=lease)
        lease.refresh()  # alive: no raise
        fake.revoke_lease(lease.id)
        # expiry drops the attached key, and refresh now fails loudly
        left = client.get_prefix("/l/")
        with pytest.raises(RuntimeError, match="expired") as err:
            lease.refresh()
        return lease.ttl, left, str(err.value).replace(str(lease.id), "<id>")

    out = each_client(make_fake, scenario)
    assert out["torch"] == out["jax"] == (30, [], "lease <id> expired (TTL<=0)")


def _consume_watch(client, fake, mod):
    events, cancel = client.watch_prefix("/w/")
    got = []
    done = threading.Event()

    def consume():
        for ev in events:
            got.append((ev.type, bytes(ev.kv.key)))
            if len(got) >= 2:
                break
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    deadline = time.monotonic() + 20
    while not fake._watches:  # let the watch register
        assert time.monotonic() < deadline, "watch never registered"
        time.sleep(0.02)
    client.put("/w/k1", "v1")
    client.delete("/w/k1")
    assert done.wait(timeout=20), got
    cancel()
    t.join(timeout=10)
    assert not t.is_alive()
    return got


def test_watch_prefix_sees_put_and_delete(make_fake):
    out = each_client(make_fake, _consume_watch)
    # PUT (0) then DELETE (1) of the same key, from both clients
    assert out["torch"] == out["jax"] == [(0, b"/w/k1"), (1, b"/w/k1")]


def test_watch_cancel_unblocks(make_fake):
    def scenario(client, fake, mod):
        events, cancel = client.watch_prefix("/wc/")
        finished = threading.Event()

        def consume():
            for _ in events:
                pass
            finished.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        deadline = time.monotonic() + 20
        while not fake._watches:
            assert time.monotonic() < deadline, "watch never registered"
            time.sleep(0.02)
        cancel()
        ok = finished.wait(timeout=20)
        t.join(timeout=10)
        return ok

    out = each_client(make_fake, scenario)
    assert out["torch"] is out["jax"] is True


def _run_pool_cycle(client, fake_or_none, pool_cls):
    """Full EtcdPool membership cycle on a real event loop; the list of
    snapshots pushed to `on_update`."""
    updates = []

    async def scenario():
        seen = asyncio.Event()

        async def on_update(peers):
            updates.append(sorted(p.address for p in peers))
            seen.set()

        pool = pool_cls(
            endpoints=["unused:0"],
            prefix="/guber-test/peers/",
            advertise="10.0.0.1:81",
            on_update=on_update,
            client=client,
        )
        try:
            await pool.start()
            assert updates[-1] == ["10.0.0.1:81"]

            # events before the watch stream finishes registering are
            # not delivered (same contract as clientv3/etcd3 watches) —
            # wait for registration before acting
            if fake_or_none is not None:
                deadline = time.monotonic() + 20
                while not fake_or_none._watches:
                    assert time.monotonic() < deadline, "watch never registered"
                    await asyncio.sleep(0.02)
            else:
                await asyncio.sleep(0.5)

            # a second node registers out-of-band: the watch pushes it
            seen.clear()
            lease2 = client.lease(30)
            client.put(
                "/guber-test/peers/10.0.0.2:81", "10.0.0.2:81", lease=lease2,
            )
            await asyncio.wait_for(seen.wait(), timeout=20)
            assert updates[-1] == ["10.0.0.1:81", "10.0.0.2:81"]

            # and its departure (lease revoke = expiry) pushes again
            seen.clear()
            lease2.revoke()
            await asyncio.wait_for(seen.wait(), timeout=20)
            assert updates[-1] == ["10.0.0.1:81"]

            if fake_or_none is not None:
                # lease-loss failure injection: revoke OUR lease behind
                # the pool's back, drive the keepalive path directly and
                # assert the pool re-registered (etcd.go:247-301)
                fake_or_none.revoke_lease(pool._lease.id)
                assert client.get_prefix("/guber-test/peers/") == []
                with pytest.raises(RuntimeError):
                    pool._lease.refresh()
                await asyncio.to_thread(pool._register)
                vals = [
                    v.decode()
                    for v, _m in client.get_prefix("/guber-test/peers/")
                ]
                assert vals == ["10.0.0.1:81"]
        finally:
            # ALWAYS close: a dangling watch worker would wedge
            # asyncio.run's executor shutdown after a failure
            await pool.close()
        # close deletes the registration key
        assert client.get_prefix("/guber-test/peers/") == []

    asyncio.run(asyncio.wait_for(scenario(), timeout=90))
    return updates


def test_pool_full_cycle_against_fake(make_fake):
    from gubernator_tpu.serve.discovery import EtcdPool as JaxEtcdPool
    from gubernator_tpu_torch.serve.discovery import EtcdPool

    pools = {"jax": JaxEtcdPool, "torch": EtcdPool}
    out = each_client(
        make_fake,
        lambda c, fake, mod: _run_pool_cycle(
            c, fake, pools["jax" if mod is jax_etcd else "torch"]
        ),
    )
    first = [["10.0.0.1:81"], ["10.0.0.1:81", "10.0.0.2:81"], ["10.0.0.1:81"]]
    assert out["torch"][:3] == out["jax"][:3] == first
    # the lease-loss injection's DELETE and re-put race the watch's reads,
    # so what follows depends on timing, but holds only these snapshots
    for updates in out.values():
        assert all(u in ([], ["10.0.0.1:81"]) for u in updates[3:]), updates


@pytest.mark.skipif(
    not REAL_ETCD,
    reason="no etcd available (set GUBER_TEST_ETCD=host:port to run "
    "against a live cluster; the fake-backed cycle above always runs)",
)
def test_pool_full_cycle_against_real_etcd():
    from gubernator_tpu_torch.serve.discovery import EtcdPool

    host, _, port = REAL_ETCD.rpartition(":")
    c = etcd_client.VendoredEtcdClient(host=host or "127.0.0.1", port=int(port))
    try:
        _run_pool_cycle(c, None, EtcdPool)
    finally:
        c.close()


def test_both_etcd_pb2_copies_load_in_one_process():
    """The port's pb2 modules carry the JAX package's serialized
    descriptors byte for byte: the default pool accepts the same file
    twice, both resolve to one descriptor, and bytes written by one parse
    identically with the other."""
    from gubernator_tpu.api.proto.gen import etcd_mvcc_pb2 as jax_mvcc
    from gubernator_tpu.api.proto.gen import etcd_rpc_pb2 as jax_rpc
    from gubernator_tpu_torch.api.proto.gen import etcd_mvcc_pb2, etcd_rpc_pb2

    for ours, theirs, name, package in (
        (etcd_mvcc_pb2, jax_mvcc, "etcd_mvcc.proto", "mvccpb"),
        (etcd_rpc_pb2, jax_rpc, "etcd_rpc.proto", "etcdserverpb"),
    ):
        assert ours.DESCRIPTOR.serialized_pb == theirs.DESCRIPTOR.serialized_pb
        assert (ours.DESCRIPTOR.name, ours.DESCRIPTOR.package) == (name, package)
    req = etcd_rpc_pb2.WatchRequest(
        create_request=etcd_rpc_pb2.WatchCreateRequest(key=b"/p/", range_end=b"/p0")
    )
    back = jax_rpc.WatchRequest.FromString(req.SerializeToString())
    assert back.create_request.range_end == b"/p0"
    ev = jax_mvcc.Event(type=jax_mvcc.Event.DELETE, kv=jax_mvcc.KeyValue(key=b"/p/a"))
    ours = etcd_mvcc_pb2.Event.FromString(ev.SerializeToString())
    assert (ours.type, ours.kv.key) == (etcd_mvcc_pb2.Event.DELETE, b"/p/a")
    assert etcd_rpc_pb2.PutRequest.DESCRIPTOR.full_name == "etcdserverpb.PutRequest"
