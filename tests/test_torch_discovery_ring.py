"""Discovery driving real rings, the port beside the JAX package on the CPU.

- `StaticPool.update` (the hand-driven ring change) feeding a port
  `Instance` and a JAX `Instance` through `on_update -> set_peers`: both
  rebuild the same ring, report the same peer count, and record the same
  rescale handoff (which keys move, and to whom).
- The acceptance case of etcd discovery: one port daemon and one JAX
  daemon (`GUBER_BACKEND=exact`, each a process of its own) register
  through one fake etcd (the JAX package's and the port's, in turn), each
  reads 2 peers, and a key owned by either node answers with the same
  owner and the same status through both nodes, forwarded or not.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.serve.backends import ExactBackend
from gubernator_tpu_torch.serve.config import BehaviorConfig, ServerConfig
from gubernator_tpu_torch.serve.discovery import StaticPool
from gubernator_tpu_torch.serve.instance import Instance

from _util import free_ports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _behaviors(mod):
    return mod.BehaviorConfig(
        peer_timeout=0.2, peer_retries=0, peer_backoff=0.001,
        peer_backoff_max=0.002, breaker_failures=3, breaker_cooldown=0.2,
    )


def test_static_pool_update_drives_the_instance_ring_change():
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.serve import config as jconfig
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend
    from gubernator_tpu.serve.discovery import StaticPool as JStaticPool
    from gubernator_tpu.serve.instance import Instance as JInstance
    from gubernator_tpu_torch.serve import config as tconfig

    me, b, c = (f"127.0.0.1:{p}" for p in free_ports(3))
    keys = [f"ring{i}" for i in range(64)]

    async def scenario(pkg):
        if pkg == "torch":
            conf = ServerConfig(
                grpc_address=me, advertise_address=me, backend="exact",
                rescale=True, replication_sync_wait=60.0,
                behaviors=_behaviors(tconfig),
            )
            inst, pool_cls, mk_req = Instance(conf, ExactBackend(1000)), StaticPool, RateLimitReq
        else:
            conf = jconfig.ServerConfig(
                grpc_address=me, advertise_address=me, backend="exact",
                rescale=True, replication_sync_wait=60.0,
                behaviors=_behaviors(jconfig),
            )
            inst, pool_cls, mk_req = JInstance(conf, JExactBackend(1000)), JStaticPool, jt.RateLimitReq
        inst.start()
        seen = []
        rings = []

        async def on_update(peers):
            await inst.set_peers(peers)
            seen.append(inst.health.peer_count)

        pool = pool_cls([me], me, on_update)
        try:
            await pool.start()
            # every key is this node's on a ring of one: decide them all so
            # the rescale manager tracks their windows
            await inst.get_rate_limits([
                mk_req(name="ring", unique_key=k, hits=1, limit=5, duration=60_000)
                for k in keys
            ])
            tracked = inst.rescale.tracked_len
            hashed = [f"ring_{k}" for k in keys]
            for members in ([me, b, c], [me, c], [me]):
                old = inst.picker
                await pool.update(members)
                new = inst.picker
                rings.append((
                    sorted(p.host for p in new.peers()),
                    [new.get(h).host for h in hashed],
                    {host: sorted(ks) for host, (_peer, ks)
                     in old.ownership_diff(new, hashed).items()},
                ))
            return seen, rings, tracked
        finally:
            await pool.close()
            await inst.stop()

    out = {pkg: asyncio.run(asyncio.wait_for(scenario(pkg), 60))
           for pkg in ("torch", "jax")}
    assert out["torch"] == out["jax"]
    seen, rings, tracked = out["torch"]
    assert seen == [1, 3, 2, 1]
    assert tracked == len(keys)
    # the first change moved some keys off this node, to b and c
    assert set(rings[0][2]) <= {b, c} and rings[0][2], rings[0]
    assert rings[2][1] == [me] * len(keys)


# -- a forward cut by a ring change ------------------------------------------


def _cut_ring(hosts):
    """(a, b, c, key) from three hosts: `key` is owned by `a` in the ring
    of all three and by `c` once `a` has left (each host has one ring
    point, so `c` is the host after `a`), and the ring of (b, c) names
    `b` the key's successor. Any key serves: the roles follow it."""
    from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient

    def ring(members):
        p = ConsistentHashPicker()
        for h in members:
            p.add(PeerClient(BehaviorConfig(), h))
        return p

    key = "k0"
    a = ring(hosts).get(f"cut_{key}").host
    cut = ring([h for h in hosts if h != a])
    c = cut.get(f"cut_{key}").host
    b = next(h for h in hosts if h not in (a, c))
    assert cut.get_successor(f"cut_{key}").host == b
    return a, b, c, key


@pytest.mark.parametrize("ring_changed", [True, False])
def test_a_forward_cut_by_a_ring_change_goes_to_the_keys_new_owner(monkeypatch, ring_changed):
    """Node b forwards a key to its owner a; the forward fails. When b's
    ring still holds a (an owner that stopped answering), both packages
    take the key over at a's successor. When the failure is b's own ring
    change (a left, set_peers closed its client mid-batch), the port
    routes the key to its owner in the ring as it now is, c, which the
    departing owner's drain handed the window to; the JAX package takes
    it over at the current ring's successor, b itself, where no snapshot
    waits, and answers from a fresh window (the port's divergence)."""
    from gubernator_tpu.api import types as jt
    from gubernator_tpu.serve import config as jconfig
    from gubernator_tpu.serve.backends import ExactBackend as JExactBackend
    from gubernator_tpu.serve.instance import Instance as JInstance
    from gubernator_tpu_torch.serve import config as tconfig

    a, b, c, key = _cut_ring(["10.0.0.1:81", "10.0.0.2:81", "10.0.0.3:81"])
    reset = 1_900_000_000_000

    async def scenario(pkg):
        if pkg == "torch":
            mod, types, inst_cls, be = tconfig, __import__(
                "gubernator_tpu_torch.api.types", fromlist=["x"]), Instance, ExactBackend
        else:
            mod, types, inst_cls, be = jconfig, jt, JInstance, JExactBackend
        conf = mod.ServerConfig(grpc_address=b, advertise_address=b, backend="exact",
                                replication=True, replication_sync_wait=60.0,
                                behaviors=_behaviors(mod))
        inst = inst_cls(conf, be(1000))
        inst.start()
        try:
            everyone = [types.PeerInfo(address=h, is_owner=(h == b)) for h in (a, b, c)]
            await inst.set_peers(everyone)
            owner = inst.picker.get_peer_by_host(a)
            if ring_changed:
                await inst.set_peers([p for p in everyone if p.address != a])
            for host in (a, c):
                peer = inst.picker.get_peer_by_host(host)
                if peer is None:
                    continue

                async def answers(reqs, host=host):
                    # the remote node's answer: the window it holds is over
                    return [types.RateLimitResp(status=types.Status.OVER_LIMIT, limit=5,
                                                remaining=0, reset_time=reset,
                                                metadata={"from": host}) for _ in reqs]

                monkeypatch.setattr(peer, "get_peer_rate_limits_grouped", answers)
            req = types.RateLimitReq(name="cut", unique_key=key, hits=1, limit=5,
                                     duration=600_000)
            (resp,) = await inst._takeover_fallback(
                [(0, req)], owner, RuntimeError(f"peer client for '{a}' closed mid-batch"))
            return int(resp.status), resp.remaining, dict(resp.metadata)
        finally:
            await inst.stop()

    out = {pkg: asyncio.run(asyncio.wait_for(scenario(pkg), 60)) for pkg in ("torch", "jax")}
    if not ring_changed:
        # the successor of a in (a, b, c): the same node, the same answer
        assert out["torch"] == out["jax"]
        assert out["torch"][2]["replicated"] == "true"
        return
    assert out["torch"] == (1, 0, {"from": c, "owner": c, "replicated": "true"})
    assert out["jax"] == (0, 4, {"owner": b, "replicated": "true"})


# -- one ring of a port daemon and a JAX daemon through the fake etcd --------


def _get(port, path):
    return json.loads(
        urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()
    )


def _post(port, reqs):
    body = json.dumps({"requests": reqs}).encode()
    return json.loads(urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/GetRateLimits", data=body,
        headers={"Content-Type": "application/json"},
    ), timeout=10).read())["responses"]


def _wait_peer_count(procs, http, want, timeout=90.0):
    deadline = time.monotonic() + timeout
    counts = {}
    while time.monotonic() < deadline:
        for name, proc in procs.items():
            assert proc.poll() is None, f"the {name} daemon exited early"
        try:
            counts = {name: _get(http[name], "/v1/HealthCheck")["peerCount"]
                      for name in procs}
        except OSError:
            counts = {}
        if counts and all(n == want for n in counts.values()):
            return counts
        time.sleep(0.1)
    raise AssertionError(f"peer counts never reached {want}: {counts}")


@pytest.mark.parametrize("which_fake", ["jax_fake", "torch_fake"])
def test_port_and_jax_daemons_join_one_ring_through_fake_etcd(which_fake, tmp_path):
    if which_fake == "jax_fake":
        from _fake_etcd import FakeEtcd
    else:
        from gubernator_tpu_torch.cli.fake_etcd import FakeEtcd

    etcd = FakeEtcd().start()
    g_t, h_t, g_j, h_j = free_ports(4)
    addr = {"torch": f"127.0.0.1:{g_t}", "jax": f"127.0.0.1:{g_j}"}
    http = {"torch": h_t, "jax": h_j}
    modules = {"torch": "gubernator_tpu_torch.cli.daemon",
               "jax": "gubernator_tpu.cli.daemon"}
    procs = {}
    try:
        for name in ("torch", "jax"):
            env = dict(
                os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
                GUBER_BACKEND="exact",
                GUBER_GRPC_ADDRESS=addr[name], GUBER_ADVERTISE_ADDRESS=addr[name],
                GUBER_HTTP_ADDRESS=f"127.0.0.1:{http[name]}",
                GUBER_ETCD_ENDPOINTS=f"127.0.0.1:{etcd.port}",
            )
            env.pop("GUBER_PEERS", None)
            log = open(tmp_path / f"{name}.log", "w")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", modules[name]], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT,
            )
            log.close()
        try:
            assert _wait_peer_count(procs, http, 2) == {"torch": 2, "jax": 2}
        except AssertionError:
            for name in procs:
                print(name, (tmp_path / f"{name}.log").read_text()[-3000:])
            raise
        assert sorted(_etcd_values(etcd)) == sorted(addr.values())

        # one key owned by each node, as both packages' rings place them
        from gubernator_tpu.serve.config import BehaviorConfig as JBehaviors
        from gubernator_tpu.serve.peers import ConsistentHashPicker as JPicker
        from gubernator_tpu.serve.peers import PeerClient as JPeerClient
        from gubernator_tpu_torch.serve.peers import ConsistentHashPicker, PeerClient

        ours, theirs = ConsistentHashPicker(), JPicker()
        for a in addr.values():
            ours.add(PeerClient(BehaviorConfig(), a))
            theirs.add(JPeerClient(JBehaviors(), a))
        owned = {}
        for i in range(256):
            key = f"disc{i}"
            host = ours.get(f"disc_{key}").host
            assert host == theirs.get(f"disc_{key}").host
            name = "torch" if host == addr["torch"] else "jax"
            owned.setdefault(name, key)
        assert set(owned) == {"torch", "jax"}, owned

        for owner_name, key in owned.items():
            # walk the key to OVER through both nodes in turn: the count is
            # one window on its owner, and every answer the other node
            # forwarded names that owner (the owner's own carry no owner)
            walk = []
            for step in range(4):
                via = ("torch", "jax")[step % 2]
                (r,) = _post(http[via], [{"name": "disc", "uniqueKey": key, "hits": 1,
                                          "limit": 3, "duration": 60_000}])
                assert not r.get("error"), r
                walk.append((via, r.get("metadata", {}).get("owner"), r["status"],
                             int(r.get("remaining", 0))))
            fwd = {name: (addr[owner_name] if name != owner_name else None)
                   for name in addr}
            assert walk == [
                ("torch", fwd["torch"], "UNDER_LIMIT", 2),
                ("jax", fwd["jax"], "UNDER_LIMIT", 1),
                ("torch", fwd["torch"], "UNDER_LIMIT", 0),
                ("jax", fwd["jax"], "OVER_LIMIT", 0),
            ], (owner_name, walk)
            # a peek through each node reads the same window
            peeks = [
                _post(http[via], [{"name": "disc", "uniqueKey": key, "hits": 0,
                                   "limit": 3, "duration": 60_000}])[0]
                for via in ("torch", "jax")
            ]
            assert [p["status"] for p in peeks] == ["OVER_LIMIT"] * 2
            assert peeks[0]["resetTime"] == peeks[1]["resetTime"]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        etcd.stop()
    # each daemon's drain deregistered it from etcd
    assert _etcd_values(etcd) == []


def _etcd_values(etcd):
    """The registered addresses, read from the fake's own table."""
    with etcd._lock:
        return [v.decode() for v, *_ in etcd._kv.values()]
