"""Env-driven fault injection for the serving tier.

The port's copy of gubernator_tpu/serve/faults.py with its imports
rewritten; the file references below are the reference package's.

The availability features this repo grew in r8 (peer deadlines, retries,
circuit breaking, degraded mode, graceful drain) are only as real as the
failures they were tested against. This module is the single injection
surface threaded through the serving hot paths so tests and the chaos
soak (scripts/chaos_soak.py) can create latency, errors, partitions, and
hangs in a REAL process — no monkeypatching, no test-only forks of the
code under test.

Spec grammar (GUBER_FAULT_SPEC): comma-separated rules

    <point>:<action>[=<value>][:<param>=<value>...]

    points : peer_rpc      — PeerClient outbound RPCs (forwards + gossip)
             peer_serve    — owner-side Instance.get_peer_rate_limits
             device_submit — the device batcher's flush path
             edge_frame    — one edge bridge frame's service
             checkpoint_write — one checkpoint flush's file write (r19)
             checkpoint_read  — the boot-time checkpoint restore read (r19)
    actions: delay=<dur>   — add latency (e.g. 200ms, 1.5s, bare ms)
             error[=<msg>] — raise FaultError (retryable by default)
             hang          — block forever (deadlines must save the caller)
    params : p=<0..1>      — injection probability (default 1.0)
             host=<substr> — only when the call's peer tag contains this
             n=<count>     — stop after injecting <count> times

Examples:

    GUBER_FAULT_SPEC='peer_rpc:delay=200ms:p=0.1,peer_rpc:error:p=0.05'
    GUBER_FAULT_SPEC='peer_rpc:error:host=10.0.0.3'     # partition one peer
    GUBER_FAULT_SPEC='device_submit:hang'

GUBER_FAULT_SEED pins the RNG so probabilistic specs are reproducible in
tests. With no spec configured the hot-path cost is one attribute check
(`FAULTS.enabled`, a plain bool). Injections are counted in
faults_injected_total{point,action} so a soak can prove its faults fired.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional

log = logging.getLogger("gubernator_tpu_torch.faults")

POINTS = (
    "peer_rpc",
    "peer_serve",
    "device_submit",
    "edge_frame",
    "checkpoint_write",
    "checkpoint_read",
)
ACTIONS = ("delay", "error", "hang")


class FaultError(RuntimeError):
    """An injected failure. `retryable` mirrors the transport-level
    "never reached the peer" class (serve/peers.py retry policy), so a
    spec can exercise both the retry path and the give-up path."""

    def __init__(self, msg: str, retryable: bool = True):
        super().__init__(msg)
        self.retryable = retryable


def parse_duration_s(text: str) -> float:
    """'200ms' / '1.5s' / bare number (milliseconds) -> seconds."""
    t = text.strip().lower()
    try:
        if t.endswith("ms"):
            return float(t[:-2]) / 1000.0
        if t.endswith("s"):
            return float(t[:-1])
        return float(t) / 1000.0
    except ValueError:
        raise ValueError(f"unparsable fault duration {text!r}") from None


@dataclass
class FaultRule:
    point: str
    action: str
    delay_s: float = 0.0
    message: str = "injected fault"
    p: float = 1.0
    host: str = ""  # substring match against the call's peer tag
    budget: Optional[int] = None  # remaining injections; None = unbounded
    injected: int = 0

    def matches(self, peer: str, rng: random.Random) -> bool:
        if self.budget is not None and self.budget <= 0:
            return False
        if self.host and self.host not in peer:
            return False
        if self.p < 1.0 and rng.random() >= self.p:
            return False
        if self.budget is not None:
            self.budget -= 1
        self.injected += 1
        return True


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse GUBER_FAULT_SPEC; raises ValueError with the offending rule
    on any typo — a chaos run with a silently-ignored rule would pass
    for the wrong reason."""
    rules: List[FaultRule] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault rule {raw!r} must be '<point>:<action>[...]'"
            )
        point = parts[0].strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} in {raw!r} "
                f"(known: {', '.join(POINTS)})"
            )
        action_part = parts[1].strip()
        action, _, value = action_part.partition("=")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} in {raw!r} "
                f"(known: {', '.join(ACTIONS)})"
            )
        rule = FaultRule(point=point, action=action)
        if action == "delay":
            if not value:
                raise ValueError(f"delay needs a duration in {raw!r}")
            rule.delay_s = parse_duration_s(value)
        elif action == "error" and value:
            rule.message = value
        elif action == "hang" and value:
            raise ValueError(f"hang takes no value in {raw!r}")
        for param in parts[2:]:
            k, sep, v = param.partition("=")
            k = k.strip()
            if not sep:
                raise ValueError(f"malformed fault param {param!r} in {raw!r}")
            if k == "p":
                rule.p = float(v)
                if not (0.0 <= rule.p <= 1.0):
                    raise ValueError(f"p={v} out of [0,1] in {raw!r}")
            elif k == "host":
                rule.host = v.strip()
            elif k == "n":
                rule.budget = int(v)
            else:
                raise ValueError(
                    f"unknown fault param {k!r} in {raw!r} "
                    f"(known: p, host, n)"
                )
        rules.append(rule)
    return rules


class FaultInjector:
    """Process-wide injector. `enabled` is the hot-path guard: call
    sites check it (a plain attribute) before awaiting inject(), so a
    production process with no spec pays one bool load per site."""

    def __init__(self):
        self.enabled = False
        self._by_point: Dict[str, List[FaultRule]] = {}
        self._rng = random.Random()

    def configure(self, spec: str, seed: Optional[int] = None) -> None:
        rules = parse_fault_spec(spec or "")
        self._by_point = {}
        for r in rules:
            self._by_point.setdefault(r.point, []).append(r)
        if seed is not None:
            self._rng = random.Random(seed)
        self.enabled = bool(rules)
        if rules:
            log.warning(
                "fault injection ACTIVE: %s",
                "; ".join(
                    f"{r.point}:{r.action} p={r.p}"
                    + (f" host~{r.host}" if r.host else "")
                    for r in rules
                ),
            )

    def clear(self) -> None:
        self._by_point = {}
        self.enabled = False

    def rules(self) -> List[FaultRule]:
        return [r for rs in self._by_point.values() for r in rs]

    async def inject(self, point: str, peer: str = "") -> None:
        """Fire every matching rule at `point`. delay sleeps, error
        raises FaultError, hang parks forever (the caller's deadline is
        what's under test). Call sites guard with `FAULTS.enabled`."""
        for rule in self._by_point.get(point, ()):
            if not rule.matches(peer, self._rng):
                continue
            self._count(point, rule.action)
            if rule.action == "delay":
                await asyncio.sleep(rule.delay_s)
            elif rule.action == "error":
                raise FaultError(
                    f"{rule.message} (injected at {point}"
                    + (f", peer {peer}" if peer else "")
                    + ")"
                )
            elif rule.action == "hang":
                log.warning("injected hang at %s (peer %r)", point, peer)
                await asyncio.Event().wait()

    @staticmethod
    def _count(point: str, action: str) -> None:
        # lazy import: faults.py must stay importable before metrics
        # (and metrics must never be able to break an injection)
        try:
            from gubernator_tpu_torch.serve import metrics

            metrics.FAULTS_INJECTED.labels(point=point, action=action).inc()
        except Exception:  # pragma: no cover - defensive
            pass


#: process-wide injector, configured from the environment at import so
#: daemons (and their subprocess tests) opt in with plain env vars
FAULTS = FaultInjector()
_spec = os.environ.get("GUBER_FAULT_SPEC", "")
if _spec:
    _seed = os.environ.get("GUBER_FAULT_SEED")
    FAULTS.configure(_spec, seed=int(_seed) if _seed else None)
