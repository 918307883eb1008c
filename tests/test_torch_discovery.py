"""The port's discovery pools (serve/discovery.py) on the CPU: the seven
cases of tests/test_discovery.py, each run through the JAX package's pool
and the port's with the same fakes (that file's FakeEtcd, FakeEndpoints,
FakeK8sWatch), asserting that both pools hand `on_update` the same
snapshots, in the same order, and what the JAX test asserts of them.
Plus `StaticPool.update`, the hand-driven ring change, against the JAX
pool's.

The pools' watches block on worker threads; every wait here polls with a
deadline, and every pool is closed in a `finally`.
"""

import asyncio
import sys
import time
import types

import pytest

import gubernator_tpu.serve.discovery as jax_discovery
import gubernator_tpu_torch.serve.discovery as torch_discovery
from test_discovery import FakeEndpoints, FakeEtcd, FakeK8sWatch, FakeLease

PACKAGES = {"jax": jax_discovery, "torch": torch_discovery}
DEADLINE_S = 20.0


def run_pool_test(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def both(scenario):
    """Run `scenario(discovery_module)` for each package; the results by
    package name."""
    return {name: scenario(mod) for name, mod in PACKAGES.items()}


def snapshot(peers):
    return sorted((p.address, p.is_owner) for p in peers)


async def poll(pred, what):
    deadline = time.monotonic() + DEADLINE_S
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


def test_static_pool_marks_owner():
    def scenario(mod):
        seen = []

        async def on_update(peers):
            seen.append([(p.address, p.is_owner) for p in peers])

        async def main():
            pool = mod.StaticPool(["a:1", "b:2"], "b:2", on_update)
            try:
                await pool.start()
            finally:
                await pool.close()

        run_pool_test(main())
        return seen

    out = both(scenario)
    assert out["torch"] == out["jax"] == [[("a:1", False), ("b:2", True)]]


def test_static_pool_update_pushes_each_ring_change():
    """`update` replaces the membership and pushes it through the same
    `on_update` as `start` (the JAX pool's ring-change hook)."""
    def scenario(mod):
        seen = []

        async def on_update(peers):
            seen.append([(p.address, p.is_owner) for p in peers])

        async def main():
            pool = mod.StaticPool(["a:1"], "a:1", on_update)
            try:
                await pool.start()
                await pool.update(["a:1", "b:2", "c:3"])
                await pool.update(["b:2"])
                assert pool.peers == ["b:2"]
            finally:
                await pool.close()

        run_pool_test(main())
        return seen

    out = both(scenario)
    assert out["torch"] == out["jax"] == [
        [("a:1", True)],
        [("a:1", True), ("b:2", False), ("c:3", False)],
        [("b:2", False)],
    ]


def test_etcd_register_watch_and_close():
    def scenario(mod):
        fake = FakeEtcd()
        updates = []

        async def on_update(peers):
            updates.append(snapshot(peers))

        async def main():
            pool = mod.EtcdPool(
                ["etcd:2379"], "/guber/", "me:81", on_update, client=fake
            )
            try:
                await pool.start()
                # registration: own key under the prefix, bound to a lease
                assert fake.kv == {"/guber/me:81": "me:81"}
                assert fake.registers == 1
                # a peer joining fires the watch -> full snapshot pushed
                fake.external_put("/guber/peer:82", "peer:82")
                await poll(lambda: len(updates) >= 2, "the peer's snapshot")
            finally:
                await pool.close()
            # close deregisters (reference etcd.go: delete on shutdown)
            assert "/guber/me:81" not in fake.kv

        run_pool_test(main())
        return updates

    out = both(scenario)
    # an identical snapshot is never pushed twice, so the watch-start
    # re-sync adds nothing whichever side of the put it lands on
    assert out["torch"] == out["jax"] == [
        [("me:81", True)],
        [("me:81", True), ("peer:82", False)],
    ]


def test_etcd_lease_loss_reregisters():
    def scenario(mod):
        fake = FakeEtcd()

        async def on_update(peers):
            pass

        async def main():
            pool = mod.EtcdPool(
                ["etcd:2379"], "/guber/", "me:81", on_update, client=fake
            )
            pool.LEASE_TTL_S = 0.09  # fast keepalive cadence for the test
            try:
                await pool.start()
                assert fake.registers == 1
                fake.lease_dead = True  # refresh now raises -> re-register
                await poll(lambda: fake.registers >= 2, "a re-register")
            finally:
                await pool.close()
            return fake.kv

        return run_pool_test(main())

    out = both(scenario)
    # re-registered under the same key, then deleted by close()
    assert out["torch"] == out["jax"] == {}


def test_etcd_tls_kwargs_thread_into_client(monkeypatch):
    """GUBER_ETCD_TLS_* reach etcd3.client as its TLS kwargs (reference
    cmd/gubernator/config.go:149-192), and a cert without its key is
    refused, by both pools alike."""
    def scenario(mod):
        captured = {}

        def fake_client(**kwargs):
            captured.update(kwargs)
            return FakeEtcd()

        fake_mod = types.ModuleType("etcd3")
        fake_mod.client = fake_client
        monkeypatch.setitem(sys.modules, "etcd3", fake_mod)

        async def on_update(peers):
            pass

        mod.EtcdPool(
            ["etcd.internal:2379"], "/guber/", "me:81", on_update,
            tls_cert="/pki/cert.pem", tls_key="/pki/key.pem",
            tls_ca="/pki/ca.pem",
        )
        with pytest.raises(ValueError) as err:
            mod.EtcdPool(
                ["etcd:2379"], "/guber/", "me:81", on_update,
                tls_cert="/pki/cert.pem",  # key missing
            )
        return captured, str(err.value)

    out = both(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {
        "host": "etcd.internal", "port": 2379,
        "ca_cert": "/pki/ca.pem", "cert_cert": "/pki/cert.pem",
        "cert_key": "/pki/key.pem",
    }


def test_etcd_tls_config_env_parse():
    from gubernator_tpu.serve.config import config_from_env as jax_config
    from gubernator_tpu_torch.serve.config import config_from_env

    env = {
        "GUBER_GRPC_ADDRESS": "127.0.0.1:81",
        "GUBER_ETCD_ENDPOINTS": "etcd:2379",
        "GUBER_ETCD_TLS_CERT": "/pki/c.pem",
        "GUBER_ETCD_TLS_KEY": "/pki/k.pem",
        "GUBER_ETCD_TLS_CA": "/pki/ca.pem",
    }
    for parse in (config_from_env, jax_config):
        conf = parse(env)
        assert conf.etcd_endpoints == ["etcd:2379"]
        assert conf.etcd_prefix == "/gubernator-tpu/peers/"
        assert conf.etcd_tls_cert == "/pki/c.pem"
        assert conf.etcd_tls_key == "/pki/k.pem"
        assert conf.etcd_tls_ca == "/pki/ca.pem"

    errors = []
    for parse in (config_from_env, jax_config):
        with pytest.raises(ValueError) as err:
            parse(dict(env, GUBER_ETCD_TLS_KEY=""))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_k8s_pool_pushes_endpoints_and_marks_self():
    def scenario(mod):
        updates = []

        async def on_update(peers):
            updates.append(snapshot(peers))

        watch = FakeK8sWatch([["10.0.0.1"], ["10.0.0.1", "10.0.0.2"]])

        async def main():
            pool = mod.K8sPool(
                namespace="default",
                selector="app=guber",
                pod_ip="10.0.0.2",
                pod_port="81",
                on_update=on_update,
                api=types.SimpleNamespace(
                    list_namespaced_endpoints=lambda *a, **k: None
                ),
                watch=watch,
            )
            try:
                await pool.start()
                await poll(lambda: len(updates) >= 2, "both endpoint events")
            finally:
                await pool.close()
                watch.stopped.set()  # release the blocked stream thread

        run_pool_test(main())
        return updates

    out = both(scenario)
    assert out["torch"] == out["jax"] == [
        [("10.0.0.1:81", False)],
        [("10.0.0.1:81", False), ("10.0.0.2:81", True)],
    ]
    # a partial injection is refused by both (it would silently rebuild
    # the other half from the real cluster)
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="inject both"):
            mod.K8sPool("default", "app=g", "10.0.0.1", "81", None,
                        api=types.SimpleNamespace())


def test_fakes_match_discovery_contract():
    """The call shapes the pools make (tests/_discovery_contract.py) bind
    to the shared fakes and to the port's vendored clients, whose method
    signatures equal the JAX package's."""
    import inspect

    from _discovery_contract import (
        ETCD_CLIENT_CALLS,
        ETCD_LEASE_CALLS,
        K8S_API_CALLS,
        K8S_WATCH_CALLS,
        assert_object_implements,
    )
    from gubernator_tpu.serve import etcd_client as jax_etcd
    from gubernator_tpu.serve import k8s_client as jax_k8s
    from gubernator_tpu_torch.serve import etcd_client, k8s_client

    fake = FakeEtcd()
    assert_object_implements(fake, ETCD_CLIENT_CALLS, "FakeEtcd")
    lease = fake.lease(30)
    assert isinstance(lease, FakeLease)
    assert_object_implements(lease, ETCD_LEASE_CALLS, "FakeLease")
    assert_object_implements(
        FakeK8sWatch([]), {"stream": K8S_WATCH_CALLS["stream"]}, "FakeK8sWatch"
    )
    events, cancel = fake.watch_prefix("/p/")
    assert callable(cancel) and hasattr(events, "__iter__")

    for ours, theirs, calls in (
        (etcd_client.VendoredEtcdClient, jax_etcd.VendoredEtcdClient,
         ETCD_CLIENT_CALLS),
        (etcd_client.VendoredLease, jax_etcd.VendoredLease, ETCD_LEASE_CALLS),
        (k8s_client.VendoredK8sApi, jax_k8s.VendoredK8sApi, K8S_API_CALLS),
        (k8s_client.VendoredK8sWatch, jax_k8s.VendoredK8sWatch,
         K8S_WATCH_CALLS),
    ):
        assert_object_implements(ours, calls, ours.__name__, unbound=True)
        for name in calls:
            assert inspect.signature(getattr(ours, name)) == inspect.signature(
                getattr(theirs, name)
            ), name
    assert inspect.signature(etcd_client.VendoredEtcdClient) == inspect.signature(
        jax_etcd.VendoredEtcdClient
    )
    assert FakeEndpoints(["10.0.0.1"]).subsets[0].addresses[0].ip == "10.0.0.1"
