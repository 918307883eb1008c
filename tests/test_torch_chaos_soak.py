"""The port's chaos soak (gubernator_tpu_torch/cli/chaos_soak.py, with
`--backend exact`) as a test, the three cases of tests/test_chaos_soak.py
on the port's daemons: 3 real daemons,
one SIGKILLed + restarted mid-load, fault injection active, drain under
load — asserting bounded error rate, breaker recovery within 2
cooldowns, zero in-flight loss, and (r11) NO QUOTA AMNESIA: a tracked
over-limit key stays over-limit through owner SIGKILL -> successor
takeover -> restart -> reconcile (GUBER_REPLICATION). Marked `slow`
(tier-1 runs `-m 'not slow'`); the fast deterministic slice of the same
machinery is tests/test_faults.py + tests/test_resilience.py +
tests/test_replication.py (for the port: tests/test_torch_replication.py,
test_torch_rescale.py, test_torch_checkpoint.py). Run it with
`pytest -m slow tests/test_torch_chaos_soak.py` (~2 min on a CPU host).
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.slow


def test_chaos_soak_passes(tmp_path):
    """The kill mode: SIGKILL, takeover, restart, reconcile, drain."""
    out = tmp_path / "chaos.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.chaos_soak",
         "--backend", "exact",
         "--seconds", "15", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"chaos soak failed:\n{proc.stdout}\n{proc.stderr}"
    )
    doc = json.loads(out.read_text())
    assert doc["pass"] and not doc["failures"]
    assert doc["error_rate"] < 0.05
    assert doc["inflight_loss"] == 0
    assert doc["recovery_s"] <= doc["recovery_bound_s"] + 1.0
    assert doc["faults_injected"] > 0
    assert doc["counts"]["degraded"] + doc["counts"]["replicated"] > 0
    # the quota-amnesia contract (r11): never under-limit during the
    # outage, over-limit again on the reborn owner, and stable after
    assert doc["amnesia_outage_samples"]["under"] == 0
    assert doc["amnesia_outage_samples"]["over"] > 0
    assert doc["reconcile_lag_s"] is not None
    assert doc["amnesia_reconciled_samples"]["under"] == 0


def test_rolling_deploy_soak_passes(tmp_path):
    """The r17 rolling-deploy soak: 3 etcd-discovered daemons
    (GUBER_RESCALE=1), every node SIGTERMed + restarted in sequence
    under live load — the canary key must answer ZERO under-limit peeks
    through all six membership changes, every drain must exit 0, the
    handoff-lag metric must stay under two flush windows, and the
    rescale counters must prove keys actually moved."""
    out = tmp_path / "rolling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.chaos_soak",
         "--backend", "exact",
         "--mode", "rolling", "--seconds", "12", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"rolling-deploy soak failed:\n{proc.stdout}\n{proc.stderr}"
    )
    doc = json.loads(out.read_text())
    assert doc["pass"] and not doc["failures"]
    assert doc["canary_samples"]["under"] == 0
    assert doc["canary_samples"]["over"] > 30
    assert len(doc["restarts"]) == 3
    assert all(r["drain_exit"] == 0 for r in doc["restarts"])
    assert doc["keys_moved_total"] > 0
    assert doc["handoff_lag_max_s"] <= doc["handoff_lag_bound_s"]
    assert doc["error_rate"] < 0.05


def test_restore_soak_passes(tmp_path):
    """The r19 full-fleet restore soak: 3 daemons checkpointing to
    per-node GUBER_CHECKPOINT_DIR, the WHOLE fleet SIGKILLed at once
    and restarted against the same directories under live load — the
    over-limit canary must answer ZERO under-limit peeks across every
    restore (the first post-restore verdict included), every cycle
    must restore a nonzero number of windows (no silent pass), and the
    restore lag must stay within the staleness bound."""
    out = tmp_path / "restore.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gubernator_tpu_torch.cli.chaos_soak",
         "--backend", "exact",
         "--mode", "restore", "--seconds", "12", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, (
        f"restore soak failed:\n{proc.stdout}\n{proc.stderr}"
    )
    doc = json.loads(out.read_text())
    assert doc["pass"] and not doc["failures"]
    assert doc["canary_samples"]["under"] == 0
    assert doc["canary_samples"]["over"] > 30
    assert len(doc["cycles"]) >= 1
    for c in doc["cycles"]:
        assert c["restored_windows_total"] > 0
        assert c["restore_lag_s"] is not None
