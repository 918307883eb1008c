"""Chaos soak (the port of scripts/chaos_soak.py): a 3-node cluster
under load while a peer is killed, restarted, and faults are injected —
the end-to-end proof of the r8 resilience layer (deadlines, retries,
circuit breaker, degraded mode, graceful drain) and, since r11, of
bucket replication (GUBER_REPLICATION: owner death without quota
amnesia).

Since r17 a second mode, `--mode rolling`, is the ROLLING-DEPLOY soak:
the same 3 daemons discover each other through an in-process fake etcd
(cli/fake_etcd.py — real gRPC, the vendored client's live wire
path), so every SIGTERM genuinely CHANGES the ring (the drain
deregisters) and every restart changes it back. Each node is restarted
in sequence under live load while a tracked over-limit canary key is
peeked continuously; GUBER_RESCALE=1 must keep it over-limit through
all six membership changes (drain handoff before deregistration,
ring-change handoff on re-registration, double-serve routing in
between) — ZERO under-admissions, with the handoff-lag metric under
two replication flush windows.

Timeline (one soak):

  phase 0  boot 3 daemons (exact backend, static full-mesh peers,
           GUBER_DEGRADED_LOCAL=1, GUBER_REPLICATION=1, breaker/retry
           knobs pinned, GUBER_FAULT_SPEC latency+error injection on
           the observer node) and drive HTTP load at all of them
  phase 1  healthy baseline; drive a tracked victim-owned key
           OVER-LIMIT (the quota-amnesia canary) and let the owner's
           replication flush ship it to the ring successor
  phase 2  SIGKILL the victim node mid-load; the observer's breaker
           must trip (health goes unhealthy, "circuit open");
           victim-owned keys get successor-takeover answers
           (metadata.replicated=true; degraded-local remains the
           fallback rung) — and the amnesia canary STAYS over-limit
           (pre-r11 it provably reset to a full window)
  phase 3  restart the victim; measure recovery = time from the victim
           serving again to the observer forwarding to it successfully
           (breaker half-open probe -> closed); must be within 2
           breaker cooldowns. Then the reconcile handback lands and
           the canary is over-limit ON THE REBORN OWNER — no amnesia
           across the restart either; its lag is recorded
  phase 4  SIGTERM the drain node under load: the daemon must
           deregister, finish in-flight work (incl. the new
           replication_flush drain step), and exit 0 within
           GUBER_DRAIN_TIMEOUT_MS + stop margin, with every accepted
           request answered (no in-flight loss)

Acceptance (exit code != 0 on violation):
  - served error rate (item errors + accepted-but-unanswered requests
    on ALIVE nodes) < 5% over the soak
  - breaker trips after the kill and recovers within 2 cooldowns of
    the victim returning
  - the amnesia canary never answers UNDER_LIMIT: not during takeover,
    not after the restart/reconcile cycle (bounded reconcile poll)
  - drain exits 0 within the budget; no in-flight request lost
  - injected faults actually fired (faults_injected_total > 0)

Writes the measured soak to --json, including takeover/reconcile lags
and the replication_lag_seconds metric.

The port's copy runs the port's daemons (`python -m
gubernator_tpu_torch.cli.daemon`) and its own fake etcd, and differs
from the reference script in three ways: `--backend {exact,tpu}` picks
the daemons' GUBER_BACKEND (exact, the host LRU, is the reference
script's constant and the only backend a host without a GPU serves;
tpu puts each daemon's state on the card as the exact-tier deployment,
an int32[2^21, 128] store of GUBER_STORE_MIB=1024 with the sketch off,
since the gates are written for exact bucket state: replication ships
exact rows and the canary is one key); `--json` has no default file in
the repository (without it the JSON goes to the run's log directory);
and the ports come from this module's own `free_ports`.

    python -m gubernator_tpu_torch.cli.chaos_soak --mode kill|rolling|restore \
        [--backend exact|tpu] [--seconds S] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

#: the checkout's root: the daemons run from it with it on PYTHONPATH
ROOT = pathlib.Path(__file__).resolve().parents[2]

BREAKER_COOLDOWN_MS = 1000
DRAIN_TIMEOUT_MS = 3000
FAULT_SPEC = "peer_rpc:delay=20ms:p=0.1,peer_rpc:error:p=0.02"
REPLICATION_SYNC_WAIT_MS = 50
# rolling mode: forwarders keep routing moved keys to the old (warm)
# owner for this long after each ring change while the new owner
# installs the handoff (GUBER_RESCALE_DOUBLE_SERVE_MS)
DOUBLE_SERVE_MS = 1000
# amnesia canary window: tiny limit, long duration (must outlive the
# whole kill -> takeover -> restart -> reconcile cycle — and, in
# rolling mode, all six membership changes of the full roll)
AMNESIA_LIMIT = 5
AMNESIA_DURATION_MS = 600_000

OBSERVER, DRAIN_NODE, VICTIM = 0, 1, 2
#: the daemons' deployment for `--backend tpu`: the exact tier on the card
TPU_ENV = {"GUBER_SKETCH": "0", "GUBER_STORE_MIB": "1024"}


def free_ports(n):
    """n distinct ephemeral localhost ports (bind-then-release)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Cluster:
    def __init__(self, n=3, etcd_port=None, rescale=False,
                 sync_wait_ms=REPLICATION_SYNC_WAIT_MS,
                 checkpoint_ms=None, backend="exact"):
        self.n = n
        self.backend = backend
        self.sync_wait_ms = sync_wait_ms
        self.grpc = free_ports(n)
        self.http = free_ports(n)
        self.peers = ",".join(f"127.0.0.1:{p}" for p in self.grpc)
        self.etcd_port = etcd_port  # None = static peers (kill mode)
        self.rescale = rescale
        self.checkpoint_ms = checkpoint_ms  # restore mode (r19)
        self.log_dir = tempfile.mkdtemp(prefix="guber-chaos-")
        self.procs = [None] * n

    def env(self, i):
        env = dict(
            os.environ,
            PYTHONPATH=str(ROOT),
            GUBER_BACKEND=self.backend,
            GUBER_GRPC_ADDRESS=f"127.0.0.1:{self.grpc[i]}",
            GUBER_HTTP_ADDRESS=f"127.0.0.1:{self.http[i]}",
            GUBER_ADVERTISE_ADDRESS=f"127.0.0.1:{self.grpc[i]}",
            GUBER_PEERS=self.peers,
            GUBER_DEGRADED_LOCAL="1",
            GUBER_PEER_TIMEOUT_MS="250",
            GUBER_PEER_RETRIES="2",
            GUBER_PEER_BACKOFF_MS="10",
            GUBER_PEER_BACKOFF_MAX_MS="50",
            GUBER_BREAKER_FAILURES="3",
            GUBER_BREAKER_COOLDOWN_MS=str(BREAKER_COOLDOWN_MS),
            GUBER_DRAIN_TIMEOUT_MS=str(DRAIN_TIMEOUT_MS),
            GUBER_REPLICATION="1",
            GUBER_REPLICATION_SYNC_WAIT_MS=str(self.sync_wait_ms),
        )
        if self.backend == "tpu":
            env.update(TPU_ENV)
        env.pop("GUBER_FAULT_SPEC", None)
        env.pop("GUBER_ETCD_ENDPOINTS", None)
        env.pop("GUBER_K8S_ENDPOINTS_SELECTOR", None)
        if self.etcd_port is not None:
            # rolling mode: etcd discovery so SIGTERM/restart genuinely
            # CHANGES the ring (the drain deregisters; the reboot
            # re-registers) — static peers would keep it fixed
            env.pop("GUBER_PEERS", None)
            env["GUBER_ETCD_ENDPOINTS"] = f"127.0.0.1:{self.etcd_port}"
        if self.rescale:
            env["GUBER_RESCALE"] = "1"
            env["GUBER_RESCALE_DOUBLE_SERVE_MS"] = str(
                DOUBLE_SERVE_MS
            )
        if self.checkpoint_ms is not None:
            # restore mode (r19): per-node checkpoint dirs that SURVIVE
            # the SIGKILL (same path across respawns of node i)
            env["GUBER_CHECKPOINT_DIR"] = os.path.join(
                self.log_dir, f"ckpt{i}"
            )
            env["GUBER_CHECKPOINT_INTERVAL_MS"] = str(self.checkpoint_ms)
        if (i == OBSERVER and self.etcd_port is None
                and self.checkpoint_ms is None):
            # latency + error injection on the observer's peer RPCs:
            # retries + deadlines must keep the served error rate flat
            # (kill mode only: the rolling soak measures handoff lag,
            # which injected latency would smear)
            env["GUBER_FAULT_SPEC"] = FAULT_SPEC
            env["GUBER_FAULT_SEED"] = "8"
        return env

    def spawn(self, i):
        out = open(os.path.join(self.log_dir, f"node{i}.log"), "a")
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "gubernator_tpu_torch.cli.daemon"],
            stdout=out, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=self.env(i),
        )

    def wait_healthy(self, i, timeout=60.0, peers=None):
        deadline = time.monotonic() + timeout
        want = peers if peers is not None else self.n
        while time.monotonic() < deadline:
            if self.procs[i].poll() is not None:
                raise RuntimeError(
                    f"node {i} died at boot; log: "
                    f"{self.log_dir}/node{i}.log"
                )
            try:
                h = get_json(
                    f"http://127.0.0.1:{self.http[i]}/v1/HealthCheck"
                )
                if h["peerCount"] == want:
                    return
            except OSError:
                pass
            time.sleep(0.1)
        raise RuntimeError(f"node {i} never became healthy")

    def log_tail(self, i, lines=30):
        try:
            text = pathlib.Path(
                self.log_dir, f"node{i}.log"
            ).read_text().splitlines()
            return "\n".join(text[-lines:])
        except OSError:
            return "<no log>"


def get_json(url, timeout=5):
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


def get_text(url, timeout=5):
    return urllib.request.urlopen(url, timeout=timeout).read().decode()


def post_limits(port, reqs, timeout=10):
    body = json.dumps({"requests": reqs}).encode()
    return json.loads(
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/GetRateLimits",
                data=body,
                headers={"Content-Type": "application/json"},
            ),
            timeout=timeout,
        ).read()
    )


class LoadGen:
    """Threaded HTTP load against the alive nodes. Each request batch
    is accounted per item: ok / degraded / item_error; a request that
    was ACCEPTED (connection + write succeeded) but never answered
    counts as in-flight loss; connection refusals count as routed-away
    (a dead listener — the client's LB would route around it), not as
    served errors."""

    def __init__(self, cluster, keys, batch=16, workers=3):
        self.cluster = cluster
        self.keys = keys
        self.batch = batch
        self.workers = workers
        self.alive = set(range(cluster.n))
        self.counts = {
            "ok": 0, "degraded": 0, "replicated": 0, "item_error": 0,
            "inflight_loss": 0, "refused": 0,
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._seq = 0

    def start(self):
        for w in range(self.workers):
            t = threading.Thread(target=self._run, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=15)

    def mark_dead(self, i):
        with self._lock:
            self.alive.discard(i)

    def mark_alive(self, i):
        with self._lock:
            self.alive.add(i)

    def snapshot(self):
        with self._lock:
            return dict(self.counts)

    def _run(self, w):
        k = w * 131
        while not self._stop.is_set():
            with self._lock:
                targets = sorted(self.alive)
            if not targets:
                time.sleep(0.05)
                continue
            node = targets[(k // self.batch) % len(targets)]
            reqs = []
            for _ in range(self.batch):
                reqs.append({
                    "name": "chaos",
                    "uniqueKey": self.keys[k % len(self.keys)],
                    "hits": 1, "limit": 10_000_000,
                    "duration": 3_600_000,
                })
                k += 1
            try:
                out = post_limits(
                    self.cluster.http[node], reqs, timeout=10
                )
                with self._lock:
                    for r in out["responses"]:
                        if r.get("error"):
                            self.counts["item_error"] += 1
                        elif r["metadata"].get("degraded") == "true":
                            self.counts["degraded"] += 1
                        elif r["metadata"].get("replicated") == "true":
                            self.counts["replicated"] += 1
                        else:
                            self.counts["ok"] += 1
            except urllib.error.URLError as e:
                refused = isinstance(
                    getattr(e, "reason", None), ConnectionRefusedError
                )
                with self._lock:
                    if refused:
                        self.counts["refused"] += self.batch
                    else:
                        # accepted but unanswered (reset / timeout /
                        # EOF): the in-flight loss a graceful drain
                        # must prevent
                        self.counts["inflight_loss"] += self.batch
            except (ConnectionError, TimeoutError, OSError):
                with self._lock:
                    self.counts["inflight_loss"] += self.batch
            time.sleep(0.01)


def find_victim_keys(cluster, victim_addr, want=8):
    """Keys the victim owns, discovered through the observer's
    metadata.owner (same technique as test_compose_topology)."""
    keys = []
    for i in range(512):
        key = f"vk{i}"
        out = post_limits(cluster.http[OBSERVER], [{
            "name": "chaos", "uniqueKey": key, "hits": 0,
            "limit": 10_000_000, "duration": 3_600_000,
        }])
        r = out["responses"][0]
        if r["error"]:
            continue
        if r["metadata"].get("owner") == victim_addr:
            keys.append(key)
            if len(keys) >= want:
                break
    if not keys:
        raise RuntimeError("no victim-owned key found in 512 tries")
    return keys


def amnesia_req(key, hits):
    return {"name": "amnesia", "uniqueKey": key, "hits": hits,
            "limit": AMNESIA_LIMIT, "duration": AMNESIA_DURATION_MS}


def find_amnesia_key(cluster, victim_addr):
    """A victim-owned key under the canary's OWN name/params — it must
    not collide with the load generator's key set, whose windows use
    different limits."""
    for i in range(512):
        key = f"amn{i}"
        out = post_limits(cluster.http[OBSERVER], [amnesia_req(key, 0)])
        r = out["responses"][0]
        if not r["error"] and r["metadata"].get("owner") == victim_addr:
            return key
    raise RuntimeError("no victim-owned amnesia key in 512 tries")


def peek_amnesia(cluster, node, key):
    """One hits=0 canary sample (peeks read the stored window without
    decrementing it, so sampling can never drive the key over-limit by
    itself and mask an amnesia reset)."""
    return post_limits(
        cluster.http[node], [amnesia_req(key, 0)]
    )["responses"][0]


def drive_amnesia_over(cluster, victim_addr, key):
    """Exhaust the canary window on its owner (remaining -> 0), then
    poll a peek until the OWNER answers OVER_LIMIT (not a degraded or
    takeover stand-in — injected faults can bounce individual drives)."""
    for _ in range(5):
        r = post_limits(
            cluster.http[OBSERVER], [amnesia_req(key, AMNESIA_LIMIT)]
        )["responses"][0]
        if not r["error"] and not r["metadata"].get("degraded"):
            break
        time.sleep(0.1)

    def owner_says_over():
        try:
            r = peek_amnesia(cluster, OBSERVER, key)
        except OSError:
            return False
        return (
            not r["error"]
            and r["status"] == "OVER_LIMIT"
            and r["metadata"].get("owner") == victim_addr
            and r["metadata"].get("degraded") != "true"
            and r["metadata"].get("replicated") != "true"
        )

    return poll_until(owner_says_over, 5.0, interval=0.1,
                      what="amnesia canary never went over-limit")


def scrape_replication_metrics(cluster, node):
    """replication_* gauges/counters from one node's /metrics."""
    out = {}
    try:
        txt = get_text(f"http://127.0.0.1:{cluster.http[node]}/metrics")
    except OSError:
        return out
    for line in txt.splitlines():
        for name in ("replication_lag_seconds",
                     "replicated_takeovers_total",
                     "replication_reconciles_total",
                     "replication_snapshots_sent_total"):
            if line.startswith(name + " "):
                out[name] = float(line.rsplit(" ", 1)[1])
    return out


def poll_until(pred, timeout, interval=0.1, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    print(f"POLL TIMEOUT: {what}", file=sys.stderr)
    return False


# -- rolling-deploy mode (r17) ----------------------------------------------


def scrape_rescale_metrics(cluster, node):
    """rescale_* gauges/counters from one node's /metrics."""
    out = {}
    try:
        txt = get_text(f"http://127.0.0.1:{cluster.http[node]}/metrics")
    except OSError:
        return out
    for line in txt.splitlines():
        for name in ("rescale_keys_moved_total",
                     "rescale_handoff_lag_seconds",
                     "rescale_double_serve_answers_total",
                     "replication_lag_seconds"):
            if line.startswith(name + " "):
                out[name] = float(line.rsplit(" ", 1)[1])
    return out


class CanaryPeeker:
    """Continuous hits=0 sampling of the amnesia canary through every
    node not currently being restarted. Any non-error UNDER_LIMIT
    answer is a quota-amnesia under-admission — the thing a planned
    handoff must make IMPOSSIBLE, not merely rare."""

    def __init__(self, cluster, key, interval=0.08):
        self.cluster = cluster
        self.key = key
        self.interval = interval
        self.excluded = set()
        self.counts = {"over": 0, "under": 0, "other": 0}
        self.unders = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)

    def exclude(self, i):
        with self._lock:
            self.excluded.add(i)

    def include(self, i):
        with self._lock:
            self.excluded.discard(i)

    def snapshot(self):
        with self._lock:
            return dict(self.counts), list(self.unders)

    def _run(self):
        idx = 0
        while not self._stop.is_set():
            with self._lock:
                nodes = [
                    i for i in range(self.cluster.n)
                    if i not in self.excluded
                ]
            if not nodes:
                time.sleep(self.interval)
                continue
            node = nodes[idx % len(nodes)]
            idx += 1
            try:
                r = peek_amnesia(self.cluster, node, self.key)
            except OSError:
                with self._lock:
                    self.counts["other"] += 1
                time.sleep(self.interval)
                continue
            with self._lock:
                if r["error"]:
                    self.counts["other"] += 1
                elif r["status"] == "OVER_LIMIT":
                    self.counts["over"] += 1
                else:
                    self.counts["under"] += 1
                    self.unders.append(
                        {"via_node": node, "response": r,
                         "t": time.time()}
                    )
            time.sleep(self.interval)


def find_owned_key(cluster, via, prefix, want_owner=None, req=None):
    """A key whose metadata.owner (as seen from `via`) matches
    `want_owner` (any owner when None)."""
    for i in range(512):
        key = f"{prefix}{i}"
        out = post_limits(
            cluster.http[via],
            [req(key, 0) if req is not None else {
                "name": "chaos", "uniqueKey": key, "hits": 0,
                "limit": 10_000_000, "duration": 3_600_000,
            }],
        )
        r = out["responses"][0]
        if r["error"]:
            continue
        owner = r["metadata"].get("owner")
        if owner and (want_owner is None or owner == want_owner):
            return key, owner
    raise RuntimeError(f"no {prefix}* key with a resolvable owner")


ROLL_SYNC_WAIT_MS = 250  # rolling-mode flush window (the lag bound unit)


def rolling_main(args) -> int:
    """Rolling deploy under live load: every node of the 3-node
    etcd-discovered cluster is SIGTERMed (drain -> handoff ->
    deregister), restarted, and re-registered in sequence. Acceptance:
    every drain exits 0, the canary key never answers UNDER_LIMIT
    through all six membership changes, the handoff-lag metric stays
    under 2 flush windows, and the rescale metrics prove the machinery
    actually moved keys (not a silent pass)."""
    from gubernator_tpu_torch.cli.fake_etcd import FakeEtcd

    etcd = FakeEtcd().start()
    cluster = Cluster(
        3, etcd_port=etcd.port, rescale=True,
        sync_wait_ms=ROLL_SYNC_WAIT_MS, backend=args.backend,
    )
    phase = max(1.0, args.seconds / 10.0)
    gen = peeker = None
    failures = []
    lag_bound_s = 2 * ROLL_SYNC_WAIT_MS / 1e3
    result = {
        "soak": "rolling_deploy_3node_etcd_rescale",
        "backend": cluster.backend,
        "nodes": 3,
        "discovery": "etcd (in-process fake, real gRPC wire path)",
        "rescale": True,
        "double_serve_ms": DOUBLE_SERVE_MS,
        "replication_sync_wait_ms": ROLL_SYNC_WAIT_MS,
        "handoff_lag_bound_s": lag_bound_s,
        "drain_timeout_ms": DRAIN_TIMEOUT_MS,
        "amnesia_limit": AMNESIA_LIMIT,
        "restarts": [],
    }
    try:
        t_boot = time.monotonic()
        for i in range(3):
            cluster.spawn(i)
        for i in range(3):
            cluster.wait_healthy(i)
        result["boot_s"] = round(time.monotonic() - t_boot, 2)
        print(f"rolling cluster up in {result['boot_s']}s; logs in "
              f"{cluster.log_dir}", file=sys.stderr)

        # the canary: any key with a resolvable owner, driven
        # over-limit ONCE and then only peeked — exactly the idle
        # frozen-refusal shape r11's dirty-flush does NOT re-ship, so
        # only the planned handoff can carry it through the roll
        canary, owner0 = find_owned_key(
            cluster, OBSERVER, "roll", req=amnesia_req
        )
        result["canary"] = {"key": canary, "initial_owner": owner0}
        r = post_limits(
            cluster.http[OBSERVER], [amnesia_req(canary, AMNESIA_LIMIT)]
        )["responses"][0]
        if r["error"]:
            failures.append(f"canary drive errored: {r}")

        def canary_over():
            rr = peek_amnesia(cluster, OBSERVER, canary)
            return not rr["error"] and rr["status"] == "OVER_LIMIT"

        if not poll_until(canary_over, 5.0,
                          what="canary never went over-limit"):
            failures.append("canary never went over-limit before roll")
        # let the r11 dirty flush ship its one snapshot, then idle
        time.sleep(3 * ROLL_SYNC_WAIT_MS / 1e3)

        keys = [f"rk{i}" for i in range(128)]
        gen = LoadGen(cluster, keys)
        gen.start()
        peeker = CanaryPeeker(cluster, canary)
        peeker.start()
        time.sleep(phase)

        # the lag gauge holds only its LAST value per node, so sample
        # after EVERY restart and keep the max — a violating first
        # handoff must not be overwritten by a fast later one
        lag_samples = []

        def sample_lags():
            for n in range(3):
                m = scrape_rescale_metrics(cluster, n)
                if "rescale_handoff_lag_seconds" in m:
                    lag_samples.append(
                        m["rescale_handoff_lag_seconds"]
                    )

        for i in range(3):
            print(f"rolling node {i} (SIGTERM + restart)",
                  file=sys.stderr)
            peeker.exclude(i)
            gen.mark_dead(i)
            time.sleep(0.5)  # in-flight work toward i settles
            t_term = time.monotonic()
            cluster.procs[i].send_signal(signal.SIGTERM)
            try:
                rc = cluster.procs[i].wait(
                    timeout=DRAIN_TIMEOUT_MS / 1e3 + 10
                )
            except subprocess.TimeoutExpired:
                rc = None
            drain_s = round(time.monotonic() - t_term, 2)
            if rc != 0:
                failures.append(
                    f"node {i} drain exit code {rc} "
                    f"(log tail:\n{cluster.log_tail(i)})"
                )
            time.sleep(phase / 2)  # serve through the 2-node window
            t_spawn = time.monotonic()
            cluster.spawn(i)
            cluster.wait_healthy(i)
            for j in range(3):
                cluster.wait_healthy(j)  # everyone sees 3 peers again
            rejoin_s = round(time.monotonic() - t_spawn, 2)
            # ride out the double-serve window + handoff before the
            # reborn node takes direct traffic again (an LB health
            # grace period, in soak form)
            time.sleep(DOUBLE_SERVE_MS / 1e3 + 0.5)
            gen.mark_alive(i)
            peeker.include(i)
            sample_lags()
            result["restarts"].append(
                {"node": i, "drain_exit": rc, "drain_s": drain_s,
                 "rejoin_s": rejoin_s}
            )
            time.sleep(phase / 2)

        time.sleep(phase)
        resc_metrics = {
            n: scrape_rescale_metrics(cluster, n) for n in range(3)
        }
        result["rescale_metrics"] = resc_metrics
        peeker.stop()
        gen.stop()
        counts, unders = peeker.snapshot()
        result["canary_samples"] = counts
        result["under_admissions"] = unders
        gc = gen.snapshot()
        result["counts"] = gc
        served = (gc["ok"] + gc["degraded"] + gc["replicated"]
                  + gc["item_error"] + gc["inflight_loss"])
        errors = gc["item_error"] + gc["inflight_loss"]
        result["error_rate"] = round(errors / served, 4) if served else 1.0

        if counts["under"] > 0:
            failures.append(
                f"QUOTA AMNESIA: canary answered UNDER_LIMIT "
                f"{counts['under']}x during the roll ({unders[:3]})"
            )
        if counts["over"] < 30:
            failures.append(
                f"too few OVER_LIMIT canary samples to judge "
                f"({counts})"
            )
        moved = sum(
            m.get("rescale_keys_moved_total", 0)
            for m in resc_metrics.values()
        )
        result["keys_moved_total"] = moved
        if moved <= 0:
            failures.append(
                "rescale_keys_moved_total == 0 everywhere — the "
                "handoff machinery never engaged (silent pass)"
            )
        sample_lags()  # final sample on top of the per-restart ones
        result["handoff_lag_max_s"] = (
            max(lag_samples) if lag_samples else None
        )
        result["handoff_lag_samples"] = len(lag_samples)
        if not lag_samples:
            failures.append("no rescale_handoff_lag_seconds scraped")
        elif max(lag_samples) > lag_bound_s:
            failures.append(
                f"handoff lag {max(lag_samples):.3f}s exceeds the "
                f"bound of 2 flush windows ({lag_bound_s:.3f}s)"
            )
        if result["error_rate"] >= 0.05:
            failures.append(
                f"served error rate {result['error_rate']:.2%} >= 5% "
                f"({gc})"
            )
        if served < 500:
            failures.append(f"soak too small to judge ({served} items)")
    finally:
        if peeker is not None:
            peeker._stop.set()
        if gen is not None:
            gen._stop.set()
        for p in cluster.procs:
            if p is not None and p.poll() is None:
                p.kill()
        for p in cluster.procs:
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        etcd.stop()

    result["pass"] = not failures
    result["failures"] = failures
    write_result(args, cluster, result)
    if failures:
        print("ROLLING-DEPLOY SOAK FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("rolling-deploy soak passed", file=sys.stderr)
    return 0


# -- full-fleet restore mode (r19) -------------------------------------------

RESTORE_CHECKPOINT_MS = 250  # restore-mode flush window (staleness unit)


def scrape_checkpoint_metrics(cluster, node):
    """checkpoint_*/restore_* gauges/counters from one node's /metrics
    (checkpoint_failures_total is labelled; sum the label children)."""
    out = {}
    try:
        txt = get_text(f"http://127.0.0.1:{cluster.http[node]}/metrics")
    except OSError:
        return out
    for line in txt.splitlines():
        for name in ("restore_lag_seconds",
                     "restored_windows_total",
                     "checkpoint_age_seconds",
                     "checkpoint_tracked_entries"):
            if line.startswith(name + " "):
                out[name] = float(line.rsplit(" ", 1)[1])
        if line.startswith("checkpoint_failures_total{"):
            out["checkpoint_failures_total"] = (
                out.get("checkpoint_failures_total", 0.0)
                + float(line.rsplit(" ", 1)[1])
            )
    return out


def restore_main(args) -> int:
    """Full-fleet SIGKILL + warm restore under live load: every node of
    the 3-node static-peers cluster checkpoints to its own directory on
    a 250 ms cadence; the whole fleet is SIGKILLed at once (a power
    event — no drain, no handoff, nothing in flight survives) and
    restarted against the same directories. Acceptance: the over-limit
    amnesia canary NEVER answers UNDER_LIMIT after any restore (zero
    under-admissions), every node actually restored windows (not a
    silent pass), and the measured restore lag stays within the
    staleness bound (one checkpoint interval + the outage itself)."""
    cluster = Cluster(
        3, checkpoint_ms=RESTORE_CHECKPOINT_MS, backend=args.backend
    )
    cycles = 2 if args.seconds >= 10 else 1
    phase = max(1.0, args.seconds / (3 * cycles + 1))
    gen = peeker = None
    failures = []
    result = {
        "soak": "full_fleet_sigkill_restore_3node",
        "backend": cluster.backend,
        "nodes": 3,
        "checkpoint_interval_ms": RESTORE_CHECKPOINT_MS,
        "replication_sync_wait_ms": REPLICATION_SYNC_WAIT_MS,
        "amnesia_limit": AMNESIA_LIMIT,
        "cycles": [],
    }
    try:
        t_boot = time.monotonic()
        for i in range(3):
            cluster.spawn(i)
        for i in range(3):
            cluster.wait_healthy(i)
        result["boot_s"] = round(time.monotonic() - t_boot, 2)
        print(f"restore cluster up in {result['boot_s']}s; logs in "
              f"{cluster.log_dir}", file=sys.stderr)

        # the canary: driven over-limit ONCE, then only peeked — the
        # idle frozen-refusal shape only a checkpoint can carry across
        # a full-fleet kill (no surviving node, no replication rescue)
        canary, owner0 = find_owned_key(
            cluster, OBSERVER, "res", req=amnesia_req
        )
        result["canary"] = {"key": canary, "initial_owner": owner0}
        r = post_limits(
            cluster.http[OBSERVER], [amnesia_req(canary, AMNESIA_LIMIT)]
        )["responses"][0]
        if r["error"]:
            failures.append(f"canary drive errored: {r}")

        def canary_over():
            rr = peek_amnesia(cluster, OBSERVER, canary)
            return not rr["error"] and rr["status"] == "OVER_LIMIT"

        if not poll_until(canary_over, 5.0,
                          what="canary never went over-limit"):
            failures.append("canary never went over-limit before kill")

        keys = [f"rk{i}" for i in range(128)]
        gen = LoadGen(cluster, keys)
        gen.start()
        peeker = CanaryPeeker(cluster, canary)
        peeker.start()

        for cycle in range(cycles):
            # live load + at least two flush windows so the canary is
            # on every owner's disk before the lights go out
            time.sleep(max(phase, 3 * RESTORE_CHECKPOINT_MS / 1e3))
            for i in range(3):
                peeker.exclude(i)
                gen.mark_dead(i)
            print(f"cycle {cycle}: SIGKILL all 3 nodes",
                  file=sys.stderr)
            t_kill = time.monotonic()
            for p in cluster.procs:
                p.send_signal(signal.SIGKILL)
            for p in cluster.procs:
                p.wait(timeout=10)
            time.sleep(0.5)  # the fleet is genuinely dark
            t_spawn = time.monotonic()
            for i in range(3):
                cluster.spawn(i)
            for i in range(3):
                cluster.wait_healthy(i)

            # first post-restore canary verdict: the restored window
            # must answer OVER on the very first successful peek — an
            # UNDER here IS the amnesia this subsystem exists to kill
            first = {}

            def first_verdict():
                try:
                    rr = peek_amnesia(cluster, OBSERVER, canary)
                except OSError:
                    return False
                if rr["error"]:
                    return False
                first.update(rr)
                return True

            if not poll_until(first_verdict, 15.0,
                              what="no canary answer after restore"):
                failures.append(
                    f"cycle {cycle}: fleet never answered the canary "
                    f"after restore (log tail:\n"
                    f"{cluster.log_tail(OBSERVER)})"
                )
            elif first["status"] != "OVER_LIMIT":
                failures.append(
                    f"cycle {cycle}: QUOTA AMNESIA — first "
                    f"post-restore canary answer was {first['status']} "
                    f"({first})"
                )
            serving_s = round(time.monotonic() - t_kill, 2)
            ckpt_metrics = {
                n: scrape_checkpoint_metrics(cluster, n)
                for n in range(3)
            }
            restored = sum(
                m.get("restored_windows_total", 0)
                for m in ckpt_metrics.values()
            )
            lag = max(
                (m["restore_lag_seconds"]
                 for m in ckpt_metrics.values()
                 if "restore_lag_seconds" in m),
                default=None,
            )
            result["cycles"].append({
                "cycle": cycle,
                "kill_to_serving_s": serving_s,
                "respawn_to_serving_s": round(
                    time.monotonic() - t_spawn, 2
                ),
                "restore_lag_s": lag,
                "restored_windows_total": restored,
                "checkpoint_metrics": ckpt_metrics,
            })
            if restored <= 0:
                failures.append(
                    f"cycle {cycle}: restored_windows_total == 0 "
                    f"everywhere — restore never engaged (silent pass)"
                )
            # the restored data is at most one interval + the outage
            # old; anything beyond that means a stale file was served
            bound_s = (RESTORE_CHECKPOINT_MS / 1e3 + 2.0
                       + (time.monotonic() - t_kill))
            if lag is None:
                failures.append(
                    f"cycle {cycle}: no restore_lag_seconds scraped"
                )
            elif lag > bound_s:
                failures.append(
                    f"cycle {cycle}: restore lag {lag:.2f}s exceeds "
                    f"the staleness bound ({bound_s:.2f}s)"
                )
            for i in range(3):
                gen.mark_alive(i)
                peeker.include(i)

        time.sleep(phase)
        peeker.stop()
        gen.stop()
        counts, unders = peeker.snapshot()
        result["canary_samples"] = counts
        result["under_admissions"] = unders
        gc = gen.snapshot()
        result["counts"] = gc
        served = (gc["ok"] + gc["degraded"] + gc["replicated"]
                  + gc["item_error"] + gc["inflight_loss"])
        errors = gc["item_error"] + gc["inflight_loss"]
        result["error_rate"] = round(errors / served, 4) if served else 1.0

        if counts["under"] > 0:
            failures.append(
                f"QUOTA AMNESIA: canary answered UNDER_LIMIT "
                f"{counts['under']}x across the kills ({unders[:3]})"
            )
        if counts["over"] < 30:
            failures.append(
                f"too few OVER_LIMIT canary samples to judge ({counts})"
            )
        if served < 300:
            failures.append(f"soak too small to judge ({served} items)")
    finally:
        if peeker is not None:
            peeker._stop.set()
        if gen is not None:
            gen._stop.set()
        for p in cluster.procs:
            if p is not None and p.poll() is None:
                p.kill()
        for p in cluster.procs:
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    result["pass"] = not failures
    result["failures"] = failures
    write_result(args, cluster, result)
    if failures:
        print("RESTORE SOAK FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("restore soak passed", file=sys.stderr)
    return 0


def write_result(args, cluster, result) -> None:
    """The soak's JSON to --json, or to the run's log directory when no
    path was given; printed in full on stdout either way."""
    out_path = pathlib.Path(
        args.json or os.path.join(cluster.log_dir, f"chaos_{args.mode}.json")
    )
    out_path.write_text(json.dumps(result, indent=2) + "\n")
    print(f"soak JSON written to {out_path}", file=sys.stderr)
    print(json.dumps(result, indent=2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="approximate total soak length")
    ap.add_argument("--json", default="",
                    help="where to write the soak's JSON (default: a "
                    "file in the run's temporary log directory)")
    ap.add_argument("--backend", choices=("exact", "tpu"), default="exact",
                    help="the daemons' GUBER_BACKEND: exact (host LRU, no "
                    "GPU) or tpu (the exact-tier store on the card, "
                    "GUBER_SKETCH=0, GUBER_STORE_MIB=1024)")
    ap.add_argument("--mode", choices=("kill", "rolling", "restore"),
                    default="kill",
                    help="kill = the r8/r11 SIGKILL soak; rolling = "
                    "the r17 rolling-deploy soak (etcd discovery, "
                    "GUBER_RESCALE, every node restarted in sequence); "
                    "restore = the r19 full-fleet SIGKILL + checkpoint "
                    "restore soak (GUBER_CHECKPOINT_DIR per node)")
    args = ap.parse_args(argv)
    if args.mode == "rolling":
        return rolling_main(args)
    if args.mode == "restore":
        return restore_main(args)
    phase = max(2.0, args.seconds / 5.0)

    cluster = Cluster(3, backend=args.backend)
    gen = None
    failures = []
    result = {
        "soak": "chaos_3node_kill_restart_drain_amnesia",
        "backend": cluster.backend,
        "nodes": 3,
        "fault_spec": FAULT_SPEC,
        "breaker_cooldown_ms": BREAKER_COOLDOWN_MS,
        "drain_timeout_ms": DRAIN_TIMEOUT_MS,
        "replication_sync_wait_ms": REPLICATION_SYNC_WAIT_MS,
        "amnesia_limit": AMNESIA_LIMIT,
        "phase_seconds": phase,
    }
    victim_addr = f"127.0.0.1:{cluster.grpc[VICTIM]}"
    try:
        t_boot = time.monotonic()
        for i in range(3):
            cluster.spawn(i)
        for i in range(3):
            cluster.wait_healthy(i)
        result["boot_s"] = round(time.monotonic() - t_boot, 2)
        print(f"cluster up in {result['boot_s']}s; logs in "
              f"{cluster.log_dir}", file=sys.stderr)

        victim_keys = find_victim_keys(cluster, victim_addr)
        # quota-amnesia canary (r11): a victim-owned key under its own
        # params, driven over-limit BEFORE the kill so its frozen
        # refusal replicates to the ring successor
        amnesia_key = find_amnesia_key(cluster, victim_addr)
        result["amnesia_key"] = amnesia_key
        keys = [f"vk{i}" for i in range(64)] + [
            f"ck{i}" for i in range(128)
        ]
        gen = LoadGen(cluster, keys)
        gen.start()

        # phase 1: healthy baseline
        time.sleep(phase)
        if not drive_amnesia_over(cluster, victim_addr, amnesia_key):
            failures.append(
                "amnesia canary never went over-limit on its owner"
            )
        # let the owner's replication flush ship the frozen window
        time.sleep(max(0.5, 6 * REPLICATION_SYNC_WAIT_MS / 1e3))

        # phase 2: kill the victim mid-run. The load generator stops
        # targeting it first (a real LB routes around a dead listener);
        # the half-second grace lets requests already written to the
        # victim's socket finish, so the in-flight-loss counter stays
        # scoped to what a GRACEFUL exit (phase 4) must prevent — a
        # SIGKILL legitimately loses its own in-flight work.
        print("killing victim", file=sys.stderr)
        gen.mark_dead(VICTIM)
        time.sleep(0.5)
        cluster.procs[VICTIM].send_signal(signal.SIGKILL)
        cluster.procs[VICTIM].wait(timeout=10)
        t_kill = time.monotonic()

        def breaker_open():
            try:
                h = get_json(
                    f"http://127.0.0.1:{cluster.http[OBSERVER]}"
                    "/v1/HealthCheck"
                )
                return h["status"] == "unhealthy" and \
                    "circuit open" in h["message"]
            except OSError:
                return False

        if poll_until(breaker_open, phase + 10,
                      what="observer breaker never tripped"):
            result["breaker_trip_s"] = round(
                time.monotonic() - t_kill, 2
            )
        else:
            failures.append("breaker never tripped after the kill")
        time.sleep(phase)

        # victim keys must be answered by a stand-in, not errored:
        # successor takeover (replicated=true) first, degraded-local as
        # the fallback rung
        out = post_limits(cluster.http[OBSERVER], [{
            "name": "chaos", "uniqueKey": victim_keys[0], "hits": 0,
            "limit": 10_000_000, "duration": 3_600_000,
        }])
        r = out["responses"][0]
        if r["error"] or (
            r["metadata"].get("degraded") != "true"
            and r["metadata"].get("replicated") != "true"
        ):
            failures.append(
                f"victim-owned key not served replicated/degraded "
                f"during the outage: {r}"
            )

        # quota-amnesia assert, takeover half: the canary STAYS
        # over-limit while its owner is dead. Sampled as peeks at the
        # DRAIN node (no fault injection there): each one forwards,
        # fails fast on the open breaker, and is answered by the ring
        # successor from the replicated standby snapshot.
        outage = {"over": 0, "under": 0, "other": 0}
        t_first_over = None
        for _ in range(8):
            try:
                r = peek_amnesia(cluster, DRAIN_NODE, amnesia_key)
            except OSError:
                outage["other"] += 1
                continue
            if r["error"]:
                outage["other"] += 1
            elif r["status"] == "OVER_LIMIT":
                outage["over"] += 1
                if (
                    t_first_over is None
                    and r["metadata"].get("replicated") == "true"
                ):
                    t_first_over = round(time.monotonic() - t_kill, 2)
            else:
                outage["under"] += 1
            time.sleep(0.1)
        result["amnesia_outage_samples"] = outage
        result["takeover_first_over_s"] = t_first_over
        if outage["under"] > 0:
            failures.append(
                f"QUOTA AMNESIA during takeover: canary answered "
                f"UNDER_LIMIT {outage['under']}x while its owner was "
                f"dead ({outage})"
            )
        if outage["over"] == 0:
            failures.append(
                f"no OVER_LIMIT takeover answers for the canary during "
                f"the outage ({outage})"
            )

        # phase 3: restart the victim; recovery clock starts when IT
        # is serving again (the breaker can only probe a live peer)
        print("restarting victim", file=sys.stderr)
        cluster.spawn(VICTIM)
        cluster.wait_healthy(VICTIM)
        t_back = time.monotonic()
        gen.mark_alive(VICTIM)

        def forwards_again():
            try:
                out = post_limits(cluster.http[OBSERVER], [{
                    "name": "chaos", "uniqueKey": victim_keys[0],
                    "hits": 0, "limit": 10_000_000,
                    "duration": 3_600_000,
                }], timeout=3)
                r = out["responses"][0]
                return (
                    not r["error"]
                    and r["metadata"].get("owner") == victim_addr
                    and r["metadata"].get("degraded") != "true"
                    and r["metadata"].get("replicated") != "true"
                )
            except OSError:
                return False

        recovered = poll_until(
            forwards_again, 2 * BREAKER_COOLDOWN_MS / 1e3 + 2.0,
            interval=0.05, what="observer never forwarded again",
        )
        result["recovery_s"] = round(time.monotonic() - t_back, 2)
        bound_s = 2 * BREAKER_COOLDOWN_MS / 1e3
        result["recovery_bound_s"] = bound_s
        if not recovered or result["recovery_s"] > bound_s + 1.0:
            failures.append(
                f"breaker recovery took {result['recovery_s']}s "
                f"(bound: 2 cooldowns = {bound_s}s + 1s poll margin)"
            )

        # quota-amnesia assert, reconcile half: the interim successor
        # hands the canary's window back (retried every replication
        # tick; the attempt doubles as a breaker probe), so the REBORN
        # owner — which restarted with an empty store — answers
        # OVER_LIMIT again within the documented lag bound, and stays
        # there. Peeks only: sampling must not re-drive the window.
        lag_bound_s = 2 * BREAKER_COOLDOWN_MS / 1e3 + 2.0

        def owner_over_again():
            try:
                r = peek_amnesia(cluster, VICTIM, amnesia_key)
            except OSError:
                return False
            return not r["error"] and r["status"] == "OVER_LIMIT"

        reconciled = poll_until(
            owner_over_again, lag_bound_s, interval=0.1,
            what="canary never over-limit on the restarted owner",
        )
        result["reconcile_lag_s"] = round(time.monotonic() - t_back, 2)
        if not reconciled:
            failures.append(
                f"QUOTA AMNESIA after restart: canary not over-limit "
                f"on the reborn owner within {lag_bound_s}s"
            )
        else:
            # stability: once reconciled it must STAY over-limit, both
            # on the owner and through a forwarding peer
            stable = {"over": 0, "under": 0, "other": 0}
            for node in (VICTIM, DRAIN_NODE, VICTIM, DRAIN_NODE,
                         VICTIM, DRAIN_NODE):
                try:
                    r = peek_amnesia(cluster, node, amnesia_key)
                except OSError:
                    stable["other"] += 1
                    continue
                if r["error"]:
                    stable["other"] += 1
                elif r["status"] == "OVER_LIMIT":
                    stable["over"] += 1
                else:
                    stable["under"] += 1
                time.sleep(0.05)
            result["amnesia_reconciled_samples"] = stable
            if stable["under"] > 0:
                failures.append(
                    f"canary flapped back under-limit after the "
                    f"reconcile ({stable})"
                )
        result["replication_metrics"] = {
            "victim": scrape_replication_metrics(cluster, VICTIM),
            "observer": scrape_replication_metrics(cluster, OBSERVER),
            "drain_node": scrape_replication_metrics(cluster, DRAIN_NODE),
        }
        time.sleep(phase)

        # phase 4: graceful drain of a node under load
        print("draining a node (SIGTERM)", file=sys.stderr)
        gen.mark_dead(DRAIN_NODE)  # LB stops routing; in-flight stays
        t_term = time.monotonic()
        cluster.procs[DRAIN_NODE].send_signal(signal.SIGTERM)
        try:
            rc = cluster.procs[DRAIN_NODE].wait(
                timeout=DRAIN_TIMEOUT_MS / 1e3 + 10
            )
        except subprocess.TimeoutExpired:
            rc = None
        result["drain_s"] = round(time.monotonic() - t_term, 2)
        if rc != 0:
            failures.append(
                f"drain node exit code {rc} "
                f"(log tail:\n{cluster.log_tail(DRAIN_NODE)})"
            )
        if result["drain_s"] > DRAIN_TIMEOUT_MS / 1e3 + 8:
            failures.append(
                f"drain took {result['drain_s']}s (budget "
                f"{DRAIN_TIMEOUT_MS / 1e3}s + stop margin)"
            )
        drained_log = cluster.log_tail(DRAIN_NODE, 100)
        result["drain_logged"] = "drained in" in drained_log
        time.sleep(max(1.0, phase / 2))

        gen.stop()
        counts = gen.snapshot()
        result["counts"] = counts
        served = (
            counts["ok"] + counts["degraded"] + counts["replicated"]
            + counts["item_error"] + counts["inflight_loss"]
        )
        errors = counts["item_error"] + counts["inflight_loss"]
        result["error_rate"] = round(errors / served, 4) if served else 1.0
        result["inflight_loss"] = counts["inflight_loss"]
        if served < 500:
            failures.append(f"soak too small to judge ({served} items)")
        if result["error_rate"] >= 0.05:
            failures.append(
                f"served error rate {result['error_rate']:.2%} >= 5% "
                f"({counts})"
            )
        if counts["inflight_loss"] > 0:
            failures.append(
                f"{counts['inflight_loss']} accepted item(s) never "
                f"answered (in-flight loss)"
            )
        if counts["degraded"] + counts["replicated"] == 0:
            failures.append(
                "no replicated/degraded answers — outage never bit?"
            )

        # the injected faults must actually have fired, and the breaker
        # must have cycled open -> closed, or this soak proved nothing
        metrics_text = get_text(
            f"http://127.0.0.1:{cluster.http[OBSERVER]}/metrics"
        )
        injected = sum(
            float(line.rsplit(" ", 1)[1])
            for line in metrics_text.splitlines()
            if line.startswith("faults_injected_total{")
        )
        result["faults_injected"] = int(injected)
        if injected <= 0:
            failures.append("faults_injected_total == 0 on the observer")
        for want in ('to="open"', 'to="closed"'):
            if not any(
                line.startswith("peer_breaker_transitions_total")
                and want in line and not line.rstrip().endswith(" 0.0")
                for line in metrics_text.splitlines()
            ):
                failures.append(
                    f"no breaker transition {want} in observer metrics"
                )
    finally:
        if gen is not None:
            gen._stop.set()
        for p in cluster.procs:
            if p is not None and p.poll() is None:
                p.kill()
        for p in cluster.procs:
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass

    result["pass"] = not failures
    result["failures"] = failures
    write_result(args, cluster, result)
    if failures:
        print("CHAOS SOAK FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("chaos soak passed", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
