"""The port daemon's multi-host roles (the cases of
tests/test_daemon_multihost.py).

- Fail-fast validation: the misconfigurations that would otherwise
  deadlock a whole mesh inside a collective (a leader without
  backend=multihost, a follower count that does not match, a follower
  without a step listener) exit `python -m gubernator_tpu_torch.cli.daemon`
  with the reference's diagnostic BEFORE any process group or device is
  touched, so they run on a host without a GPU.
- Two processes serving on the CPU through `cli.daemon.run_role(conf,
  device="cpu")` (the daemon itself has no CPU switch): a leader serving
  gRPC over a 2-process mesh with a follower in lockstep, a key walked to
  OVER_LIMIT, health, and a leader SIGTERM whose step-pipe close releases
  the follower (both exit 0). The reference marks its twin slow for XLA's
  ladder compile; the port compiles nothing, so this one is not.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import grpc
import pytest

from _util import free_ports

ROOT = pathlib.Path(__file__).resolve().parent.parent

ROLE = (
    "import sys\n"
    "from gubernator_tpu_torch.cli.daemon import run_role\n"
    "from gubernator_tpu_torch.serve.config import config_from_env\n"
    "from gubernator_tpu_torch.serve.logging_setup import setup_logging\n"
    "setup_logging(level='info')\n"
    "sys.exit(run_role(config_from_env(), device='cpu'))\n"
)


def _clean_env(**extra) -> dict:
    """The ambient env minus any stray GUBER_* vars (a developer shell's
    GUBER_DIST_STEP_LISTEN would defeat the fail-fast assertions)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def _run_daemon_env(env_lines, timeout=60):
    """Run the daemon with a config file; return (rc, output)."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".conf", delete=False) as f:
        f.write("\n".join(env_lines) + "\n")
        path = f.name
    try:
        out = subprocess.run(
            [sys.executable, "-m", "gubernator_tpu_torch.cli.daemon", "--config", path],
            capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=_clean_env(),
        )
        return out.returncode, out.stdout + out.stderr
    finally:
        os.unlink(path)


def test_leader_requires_multihost_backend():
    rc, out = _run_daemon_env([
        "GUBER_GRPC_ADDRESS=127.0.0.1:0",
        "GUBER_BACKEND=exact",
        "GUBER_DIST_COORDINATOR=127.0.0.1:1",
        "GUBER_DIST_NUM_PROCESSES=2",
        "GUBER_DIST_PROCESS_ID=0",
        "GUBER_DIST_FOLLOWERS=127.0.0.1:2",
    ])
    assert rc != 0
    assert "GUBER_BACKEND=multihost" in out, out[-500:]


def test_leader_follower_count_must_match():
    rc, out = _run_daemon_env([
        "GUBER_GRPC_ADDRESS=127.0.0.1:0",
        "GUBER_BACKEND=multihost",
        "GUBER_DIST_COORDINATOR=127.0.0.1:1",
        "GUBER_DIST_NUM_PROCESSES=3",
        "GUBER_DIST_PROCESS_ID=0",
        "GUBER_DIST_FOLLOWERS=127.0.0.1:2",
    ])
    assert rc != 0
    assert "implies" in out and "2 followers" in out, out[-500:]


def test_follower_requires_step_listen():
    rc, out = _run_daemon_env([
        "GUBER_GRPC_ADDRESS=127.0.0.1:0",
        "GUBER_DIST_COORDINATOR=127.0.0.1:1",
        "GUBER_DIST_NUM_PROCESSES=2",
        "GUBER_DIST_PROCESS_ID=1",
    ])
    assert rc != 0
    assert "GUBER_DIST_STEP_LISTEN" in out, out[-500:]


def test_two_process_serving_on_the_cpu(tmp_path):
    """A leader and a follower through run_role on the CPU: gRPC serving
    over the 2-process mesh (the smallest ladder the serving tier allows,
    GUBER_DEVICE_BATCH_LIMIT=1024), a key walked to OVER_LIMIT, health,
    and a graceful leader SIGTERM that releases the follower; the
    follower's report counts the decides it ran in lockstep."""
    from gubernator_tpu_torch.api.grpc_glue import V1Stub
    from gubernator_tpu_torch.api.proto.gen import gubernator_pb2

    coord_port, step_port, grpc_port, http_port = free_ports(4)
    base = _clean_env(
        GUBER_DIST_COORDINATOR=f"127.0.0.1:{coord_port}",
        GUBER_DIST_NUM_PROCESSES="2",
        GUBER_DEVICE_BATCH_LIMIT="1024",
        GUBER_STORE_SLOTS="256",
        GUBER_SKETCH_MIB="1",
    )
    # logs go to files, not pipes: an undrained pipe would block a daemon
    l_log, f_log = tmp_path / "leader.log", tmp_path / "follower.log"
    with open(f_log, "w") as fo, open(l_log, "w") as lo:
        follower = subprocess.Popen(
            [sys.executable, "-c", ROLE],
            env=dict(base, GUBER_DIST_PROCESS_ID="1",
                     GUBER_DIST_STEP_LISTEN=f"127.0.0.1:{step_port}"),
            stdout=fo, stderr=subprocess.STDOUT, cwd=ROOT,
        )
        leader = subprocess.Popen(
            [sys.executable, "-c", ROLE],
            env=dict(base, GUBER_BACKEND="multihost", GUBER_DIST_PROCESS_ID="0",
                     GUBER_DIST_FOLLOWERS=f"127.0.0.1:{step_port}",
                     GUBER_GRPC_ADDRESS=f"127.0.0.1:{grpc_port}",
                     GUBER_HTTP_ADDRESS=f"127.0.0.1:{http_port}",
                     GUBER_PEERS=f"127.0.0.1:{grpc_port}",
                     GUBER_ADVERTISE_ADDRESS=f"127.0.0.1:{grpc_port}"),
            stdout=lo, stderr=subprocess.STDOUT, cwd=ROOT,
        )

    def _fail(msg):
        for p in (leader, follower):
            p.kill()
            p.wait(timeout=10)
        pytest.fail(f"{msg}\nleader:\n{l_log.read_text()[-3000:]}\n"
                    f"follower:\n{f_log.read_text()[-3000:]}")

    try:
        chan = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        stub = V1Stub(chan)
        deadline = time.monotonic() + 90
        hc = None
        while time.monotonic() < deadline:
            if leader.poll() is not None or follower.poll() is not None:
                _fail("a process died during startup")
            try:
                hc = stub.HealthCheck(gubernator_pb2.HealthCheckReq(), timeout=2)
                break
            except grpc.RpcError:
                time.sleep(0.5)
        if hc is None:
            _fail("the leader's gRPC never became healthy")
        assert hc.status == "healthy", hc
        assert "multi-process over gloo" in l_log.read_text()

        r = gubernator_pb2.RateLimitReq(name="mh-daemon", unique_key="k", hits=1, limit=2,
                                        duration=60_000)
        seq = []
        for _ in range(3):
            resp = stub.GetRateLimits(gubernator_pb2.GetRateLimitsReq(requests=[r]),
                                      timeout=30).responses[0]
            seq.append((resp.status, resp.remaining))
        assert seq == [(0, 1), (0, 0), (1, 0)], seq
        chan.close()

        # SIGTERM the leader: its drain closes the step pipe, which must
        # end the follower's loop on its own
        leader.send_signal(signal.SIGTERM)
        try:
            l_rc = leader.wait(timeout=60)
            f_rc = follower.wait(timeout=30)
        except subprocess.TimeoutExpired:
            _fail("a process outlived the leader's SIGTERM")
        assert l_rc == 0, l_log.read_text()[-3000:]
        assert f_rc == 0, f_log.read_text()[-3000:]
        report = next(json.loads(ln)["multihost_follower"]
                      for ln in f_log.read_text().splitlines()
                      if ln.startswith('{"multihost_follower"'))
        assert report["process"] == 1 and report["n_local"] == 1, report
        # the warmup's decides and the walk's three, each run in lockstep
        assert report["decides"] >= 3 and report["steps"]["hello"] == 1, report
        # the scan kernel's count sits beside the writeback's (0 on the CPU)
        assert report["scan_launches"] == report["launches"] == 0, report
    finally:
        for p in (leader, follower):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
