"""The port's vendored Kubernetes Endpoints client (serve/k8s_client.py)
and K8sPool over real HTTP: the six cases of tests/test_k8s_vendored.py,
each run with the JAX package's client and the port's against that
file's FakeK8sApiServer (a fresh server for each), with the same results
asserted of both.
"""

import asyncio
import json
import threading
import time

import pytest

from gubernator_tpu.serve import k8s_client as jax_k8s
from gubernator_tpu_torch.serve import k8s_client
from test_k8s_vendored import FakeK8sApiServer, _chunk

CLIENTS = {"jax": jax_k8s, "torch": k8s_client}


def each_client(scenario):
    """`scenario(fake, client_module)` on a fresh fake for each package's
    client; the results by package name."""
    out = {}
    for name, mod in CLIENTS.items():
        fake = FakeK8sApiServer()
        try:
            out[name] = scenario(fake, mod)
        finally:
            fake.stop()
    return out


def api_for(fake, mod):
    return mod.VendoredK8sApi(
        base_url=f"http://127.0.0.1:{fake.port}", token=fake.token
    )


def wait_for_watcher(fake):
    deadline = time.monotonic() + 20
    while not fake.watcher_count():
        assert time.monotonic() < deadline, "the watch never connected"
        time.sleep(0.02)


def test_bad_token_rejected():
    def scenario(fake, mod):
        bad = mod.VendoredK8sApi(
            base_url=f"http://127.0.0.1:{fake.port}", token="wrong"
        )
        with pytest.raises(RuntimeError, match="401") as err:
            bad.list_namespaced_endpoints("default")
        return str(err.value)

    out = each_client(scenario)
    assert out["torch"] == out["jax"]


def test_list_endpoints():
    def scenario(fake, mod):
        fake._subsets = ["10.0.0.1", "10.0.0.2"]
        out = api_for(fake, mod).list_namespaced_endpoints(
            "default", label_selector="app=g"
        )
        return [a.ip for e in out.items for s in e.subsets for a in s.addresses]

    out = each_client(scenario)
    assert out["torch"] == out["jax"] == ["10.0.0.1", "10.0.0.2"]


def test_watch_stream_initial_and_updates():
    def scenario(fake, mod):
        fake._subsets = ["10.0.0.1"]
        api = api_for(fake, mod)
        w = mod.VendoredK8sWatch()
        got = []
        done = threading.Event()

        def consume():
            for ev in w.stream(
                api.list_namespaced_endpoints, "default",
                label_selector="app=g",
            ):
                ips = [a.ip for s in ev["object"].subsets for a in s.addresses]
                got.append((ev["type"], ips))
                if len(got) >= 2:
                    done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        wait_for_watcher(fake)
        fake.set_ips(["10.0.0.1", "10.0.0.9"])
        assert done.wait(timeout=20), got
        w.stop()
        t.join(timeout=10)
        assert not t.is_alive()
        return got

    out = each_client(scenario)
    assert out["torch"] == out["jax"] == [
        ("ADDED", ["10.0.0.1"]), ("MODIFIED", ["10.0.0.1", "10.0.0.9"]),
    ]


def test_pool_full_cycle_against_fake():
    """K8sPool over the vendored client: initial membership, a scale-up
    event, a scale-down event, clean close — all over a real socket."""
    from gubernator_tpu.serve.discovery import K8sPool as JaxK8sPool
    from gubernator_tpu_torch.serve.discovery import K8sPool

    pools = {jax_k8s: JaxK8sPool, k8s_client: K8sPool}

    def scenario(fake, mod):
        fake._subsets = ["10.0.0.1", "10.0.0.2"]
        updates = []

        async def main():
            seen = asyncio.Event()

            async def on_update(peers):
                updates.append(sorted((p.address, p.is_owner) for p in peers))
                seen.set()

            pool = pools[mod](
                namespace="default",
                selector="app=guber",
                pod_ip="10.0.0.2",
                pod_port="81",
                on_update=on_update,
                api=api_for(fake, mod),
                watch=mod.VendoredK8sWatch(),
            )
            try:
                await pool.start()
                await asyncio.wait_for(seen.wait(), timeout=20)
                seen.clear()
                fake.set_ips(["10.0.0.1", "10.0.0.2", "10.0.0.3"])
                await asyncio.wait_for(seen.wait(), timeout=20)
                seen.clear()
                fake.set_ips(["10.0.0.2"])
                await asyncio.wait_for(seen.wait(), timeout=20)
            finally:
                await pool.close()

        asyncio.run(asyncio.wait_for(main(), timeout=90))
        return updates

    out = each_client(scenario)
    assert out["torch"] == out["jax"] == [
        [("10.0.0.1:81", False), ("10.0.0.2:81", True)],  # self by pod ip
        [("10.0.0.1:81", False), ("10.0.0.2:81", True), ("10.0.0.3:81", False)],
        [("10.0.0.2:81", True)],
    ]


def test_watch_error_event_raises_instead_of_wiping_peers():
    """An ERROR watch event carries a Status object, not Endpoints: both
    clients raise (the kubernetes library's behavior) so the pool's retry
    path re-lists instead of pushing an empty peer list."""
    def scenario(fake, mod):
        fake._subsets = ["10.0.0.1"]
        w = mod.VendoredK8sWatch()
        stream = w.stream(api_for(fake, mod).list_namespaced_endpoints, "default")
        first = next(stream)  # synthesized ADDED
        with fake._lock:
            err = json.dumps(
                {"type": "ERROR",
                 "object": {"kind": "Status", "message": "too old"}}
            ).encode() + b"\n"
            for ws in fake._watchers:
                ws.sendall(_chunk(err))
        with pytest.raises(RuntimeError, match="ERROR event") as raised:
            next(stream)
        w.stop()
        return first["type"], str(raised.value)

    out = each_client(scenario)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "ADDED"


def test_token_reread_per_request(tmp_path):
    """In-cluster tokens rotate (~1h): both clients send the CURRENT file
    contents, not the boot-time value."""
    def scenario(fake, mod):
        tok = tmp_path / f"token-{mod.__name__}"
        tok.write_text("first-token")
        fake.token = "first-token"
        api = mod.VendoredK8sApi(
            base_url=f"http://127.0.0.1:{fake.port}", token="ignored"
        )
        api._token_path = str(tok)  # the in-cluster constructor sets this
        fake._subsets = ["10.0.0.1"]
        before = len(api.list_namespaced_endpoints("default").items)
        # rotate: both the file and the server's expectation change
        tok.write_text("second-token")
        fake.token = "second-token"
        after = len(api.list_namespaced_endpoints("default").items)
        return before, after

    out = each_client(scenario)
    assert out["torch"] == out["jax"] == (1, 1)
