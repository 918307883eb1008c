"""The port's load generator (cli/loadgen.py) and client helpers against
the JAX package's, on the CPU.

- `_shed_pool` and `_chain_levels` build the same requests as the JAX
  loadgen's, field for field, over shares, key spaces, algorithms and
  chain depths;
- the client helpers (`random_peer`, `random_string`, `sleep_until_reset`)
  mirror tests/test_loadgen_and_client_helpers.py:18-39;
- the loadgen runs of that file (:85-160) run against port clusters, on
  the exact backend and on `TorchBackend(device="cpu")`;
- across the packages: the port's loadgen drives a JAX `LocalCluster`,
  and the JAX loadgen a port `LocalCluster`, with 0 errors;
- two `python -m gubernator_tpu_torch.cli.daemon` processes on the exact
  backend (the one daemon that needs no GPU), static peers, driven by
  loadgen processes of their own: gRPC forwarding and chains over the GEB
  door, 0 errors, the over-limit share near the asked one.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import gubernator_tpu.cli.loadgen as jl
import gubernator_tpu_torch.cli.loadgen as tl
from gubernator_tpu.cluster import LocalCluster as JLocalCluster
from gubernator_tpu.serve.backends import ExactBackend as JExactBackend
from gubernator_tpu_torch.api.types import RateLimitResp, millisecond_now
from gubernator_tpu_torch.client import random_peer, random_string, sleep_until_reset
from gubernator_tpu_torch.cluster import LocalCluster
from gubernator_tpu_torch.core.engine import buckets_for_limit
from gubernator_tpu_torch.core.store import StoreConfig
from gubernator_tpu_torch.serve.backends import ExactBackend, TorchBackend
from _util import free_ports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(req) -> tuple:
    """Every wire field of a RateLimitReq, enums as ints, the chain as
    (name, limit, duration) levels: comparable across the two packages."""
    return (req.name, req.unique_key, req.hits, req.limit, req.duration,
            int(req.algorithm), int(req.behavior),
            tuple((c.unique_key, c.limit, c.duration) for c in req.chain))


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 5])
def test_chain_levels_match(depth):
    for tenant in (0, 1, 5, 63, 64, 1001):
        t = [(c.unique_key, c.limit, c.duration) for c in tl._chain_levels(depth, tenant)]
        j = [(c.unique_key, c.limit, c.duration) for c in jl._chain_levels(depth, tenant)]
        assert t == j


@pytest.mark.parametrize("share,batch,keyspace", [
    (0.0, 100, 0), (0.5, 50, 0), (0.9, 1000, 0), (1.0, 64, 0),
    (0.5, 100, 3000), (0.9, 64, 1000)])
@pytest.mark.parametrize("algorithm,chain_depth", [
    ("token", 0), ("leaky", 0), ("sliding", 3), ("gcra", 1)])
def test_shed_pool_matches(share, batch, keyspace, algorithm, chain_depth):
    t = tl._shed_pool(share, batch, keyspace, tl.ALGOS[algorithm], chain_depth)
    j = jl._shed_pool(share, batch, keyspace, jl.ALGOS[algorithm], chain_depth)
    assert len(t) == len(j)
    assert [[_fields(r) for r in b] for b in t] == [[_fields(r) for r in b] for b in j]


def test_algorithm_names_match():
    assert {k: int(v) for k, v in tl.ALGOS.items()} == {k: int(v) for k, v in jl.ALGOS.items()}
    assert (tl.HOT_KEYS, tl.COLD_KEYS, tl.CALL_TIMEOUT) == (jl.HOT_KEYS, jl.COLD_KEYS,
                                                          jl.CALL_TIMEOUT)


# -- the client helpers (mirrors of tests/test_loadgen_and_client_helpers.py:18-39)


def test_random_helpers():
    peers = ["a:1", "b:2", "c:3"]
    seen = {random_peer(peers) for _ in range(100)}
    assert seen <= set(peers) and len(seen) > 1
    s1, s2 = random_string("id-"), random_string("id-")
    assert s1.startswith("id-") and s2.startswith("id-") and s1 != s2
    assert len(random_string("", 10)) == 10


def test_sleep_until_reset_waits_until_window():
    resp = RateLimitResp(reset_time=millisecond_now() + 150)
    t0 = time.monotonic()
    sleep_until_reset(resp)
    assert time.monotonic() - t0 >= 0.10
    t0 = time.monotonic()
    sleep_until_reset(RateLimitResp(reset_time=millisecond_now() - 1000))
    assert time.monotonic() - t0 < 0.05


def test_client_exports_the_helpers():
    import gubernator_tpu.client as jc
    import gubernator_tpu_torch.client as tc

    assert tc.__all__ == jc.__all__


# -- loadgen runs on port clusters (mirrors of :85-160) -------------------------


def _exact():
    return ExactBackend(10_000)


def _torch_cpu():
    # the ladder a cluster node's default GUBER_DEVICE_BATCH_LIMIT asks for
    return TorchBackend(StoreConfig(rows=4, slots=1 << 10), buckets=buckets_for_limit(1000),
                        device="cpu")


BACKENDS = {"exact": _exact, "torch_cpu": _torch_cpu}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_loadgen_against_cluster(backend, capsys):
    cluster = LocalCluster([f"127.0.0.1:{p}" for p in free_ports(2)],
                           backend_factory=BACKENDS[backend])
    cluster.start()
    try:
        stderr = io.StringIO()
        with contextlib.redirect_stderr(stderr):
            asyncio.run(tl.run(cluster.peer_at(0), keys=40, concurrency=3, batch=8,
                               duration=1.0))
        summary = stderr.getvalue()
        assert "sent=" in summary and "errors=0" in summary, summary
        assert "over the limit" in capsys.readouterr().out
    finally:
        cluster.stop()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_loadgen_geb_protocol_and_shed_shape(backend):
    g, geb = free_ports(2)
    cluster = LocalCluster([f"127.0.0.1:{g}"], backend_factory=BACKENDS[backend],
                           geb_ports=[geb])
    cluster.start()
    try:
        summary = asyncio.run(tl.run(
            f"127.0.0.1:{geb}", keys=0, concurrency=4, batch=50, duration=1.0,
            protocol="geb", share=0.5, quiet=True))
        assert summary["protocol"] == "geb"
        assert summary["errors"] == 0 and summary["sent"] > 0
        assert summary["client"]["transport"] == "tcp"
        assert 0.3 <= summary["over_limit_share"] <= 0.55, summary
    finally:
        cluster.stop()


def test_loadgen_http_protocol_against_port_cluster():
    g, h = free_ports(2)
    cluster = LocalCluster([f"127.0.0.1:{g}"], backend_factory=_exact,
                           http_addresses=[f"127.0.0.1:{h}"])
    cluster.start()
    try:
        summary = asyncio.run(tl.run(
            f"127.0.0.1:{h}", keys=0, concurrency=2, batch=20, duration=0.5,
            protocol="http", share=0.5, quiet=True))
        assert summary["errors"] == 0 and summary["sent"] > 0
    finally:
        cluster.stop()


def test_shm_protocol_refuses_to_fall_back():
    """`--protocol shm` over TCP has no mapped ring to use: every call
    fails and is counted, none is served over the socket instead."""
    g, geb = free_ports(2)
    cluster = LocalCluster([f"127.0.0.1:{g}"], backend_factory=_exact, geb_ports=[geb])
    cluster.start()
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            summary = asyncio.run(tl.run(
                f"127.0.0.1:{geb}", keys=0, concurrency=1, batch=10, duration=0.3,
                protocol="shm", share=0.5, quiet=True))
        assert summary["sent"] == 0 and summary["errors"] > 0, summary
        assert summary["client"]["frames_socket"] == 0
        assert "no lane mapped" in err.getvalue()
    finally:
        cluster.stop()


# -- the wire across the packages ---------------------------------------------


@pytest.mark.parametrize("protocol", ["grpc", "geb"])
def test_port_loadgen_drives_a_jax_cluster(protocol):
    g, geb = free_ports(2)
    cluster = JLocalCluster([f"127.0.0.1:{g}"], backend_factory=lambda: JExactBackend(10_000),
                            geb_ports=[geb])
    cluster.start()
    try:
        target = f"127.0.0.1:{geb}" if protocol == "geb" else cluster.peer_at(0)
        summary = asyncio.run(tl.run(target, keys=0, concurrency=3, batch=50, duration=0.5,
                                     protocol=protocol, share=0.5, quiet=True,
                                     chain_depth=3 if protocol == "geb" else 0))
        assert summary["errors"] == 0 and summary["sent"] > 0, summary
    finally:
        cluster.stop()


@pytest.mark.parametrize("protocol", ["grpc", "geb"])
def test_jax_loadgen_drives_a_port_cluster(protocol):
    g, geb = free_ports(2)
    cluster = LocalCluster([f"127.0.0.1:{g}"], backend_factory=_torch_cpu, geb_ports=[geb])
    cluster.start()
    try:
        target = f"127.0.0.1:{geb}" if protocol == "geb" else cluster.peer_at(0)
        summary = asyncio.run(jl.run(target, keys=0, concurrency=3, batch=50, duration=0.5,
                                     protocol=protocol, share=0.5, quiet=True,
                                     chain_depth=3 if protocol == "geb" else 0))
        assert summary["errors"] == 0 and summary["sent"] > 0, summary
    finally:
        cluster.stop()


# -- daemons in processes of their own, driven by loadgen processes ------------


def _metric_sum(text: str, name: str, contains: str) -> float:
    return sum(float(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith(name + "{") and contains in ln)


def _loadgen(target: str, *args: str) -> dict:
    r = subprocess.run([sys.executable, "-m", "gubernator_tpu_torch.cli.loadgen", target,
                        "--json", *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_exact_daemons_driven_by_loadgen_processes():
    n = 2
    ports = free_ports(3 * n)
    grpc_addrs = [f"127.0.0.1:{p}" for p in ports[:n]]
    http_addrs = [f"127.0.0.1:{p}" for p in ports[n:2 * n]]
    geb_ports = ports[2 * n:]
    doors = ",".join(f"{a}=127.0.0.1:{p}" for a, p in zip(grpc_addrs, geb_ports))
    procs, logs = [], []
    try:
        for i in range(n):
            env = dict(os.environ, GUBER_BACKEND="exact", GUBER_GRPC_ADDRESS=grpc_addrs[i],
                       GUBER_ADVERTISE_ADDRESS=grpc_addrs[i], GUBER_HTTP_ADDRESS=http_addrs[i],
                       GUBER_PEERS=",".join(grpc_addrs), GUBER_GEB_PORT=str(geb_ports[i]),
                       GUBER_GEB_PEER_DOORS=doors, GUBER_CHAINS="1")
            log = open(os.devnull, "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gubernator_tpu_torch.cli.daemon"], cwd=ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 120
        for i, h in enumerate(http_addrs):
            while True:
                assert procs[i].poll() is None, f"daemon {i} exited {procs[i].returncode}"
                try:
                    urllib.request.urlopen(f"http://{h}/v1/HealthCheck", timeout=2).read()
                    break
                except OSError:
                    assert time.monotonic() < deadline, f"daemon {i} did not open its doors"
                    time.sleep(0.2)
        m0 = [urllib.request.urlopen(f"http://{h}/metrics").read().decode() for h in http_addrs]
        fwd = _loadgen(grpc_addrs[0], "--protocol", "grpc", "--batch", "100",
                       "--concurrency", "4", "--share", "0.9", "--duration", "1")
        m1 = [urllib.request.urlopen(f"http://{h}/metrics").read().decode() for h in http_addrs]
        chain = _loadgen(f"127.0.0.1:{geb_ports[0]}", "--protocol", "geb", "--chain-depth", "3",
                         "--batch", "64", "--concurrency", "2", "--share", "0.5",
                         "--duration", "1")
        for s, share in ((fwd, 0.9), (chain, 0.5)):
            assert s["errors"] == 0 and s["sent"] > 0, s
            # hot keys freeze over the limit after their first touch; a
            # short run leaves more first touches in the share
            assert share - 0.15 <= s["over_limit_share"] <= share + 0.001, s
        assert "client" not in fwd  # the gRPC client keeps no transport stats
        # chained items ride string frames by contract, so a fast hello
        # downgrades; the transport stays the socket the leg asked for
        assert chain["client"]["transport"] == "tcp"
        peer_rpcs = sum(
            _metric_sum(b, "grpc_request_counts_total", "GetPeerRateLimits")
            - _metric_sum(a, "grpc_request_counts_total", "GetPeerRateLimits")
            for a, b in zip(m0[1:], m1[1:]))
        assert peer_rpcs > 0, "node 0 forwarded nothing to its peer"
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(10)
        for log in logs:
            log.close()


def test_loadgen_module_loads_no_torch():
    code = ("import sys\n"
            "import gubernator_tpu_torch.cli.loadgen as lg\n"
            "lg._shed_pool(0.5, 10, chain_depth=3)\n"
            "lg._make_client('grpc', '127.0.0.1:1', 0, 'auto')\n"
            "lg._make_client('geb', '127.0.0.1:1', 0, 'auto')\n"
            "lg._make_client('http', '127.0.0.1:1', 0, 'auto')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('torch', 'jax', 'jaxlib', 'gubernator_tpu')]\n"
            "assert not bad, bad\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr
