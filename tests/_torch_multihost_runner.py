"""One process of the port's multi-process mesh (spawned by
tests/test_torch_multihost.py and tests/test_torch_cuda.py); the port's
twin of tests/_multihost_runner.py.

Run as:
  python tests/_torch_multihost_runner.py <role> <coordinator> <step_ports> \
      <process_id> <num_processes> <shards_per_process> <device> <outdir>

`step_ports` is comma-separated: the leader connects to one port per
follower; a follower listens on its own (single) entry. Each process holds
`shards_per_process` shards of `device` (cpu, or cuda:0 on a GPU host), so
one runner covers the 2x1, 2x4 and 4x2 topologies; the processes join one
torch.distributed group over gloo. Role "leader" runs the reference
runner's legs (three charges then OVER across every shard, sync_globals,
update_globals, two submits in flight, GLOBAL hits and promotes against a
flat engine, sliding and GCRA served by a way-saturated bucket's ring
against the host twins), prints LEADER-OK and a `TOPO shards=<n>
b_sub=<B>` work line, then runs `traffic_script` after a reset and writes
its outputs to <outdir>/responses.npz. Every process writes its local
shards' store and sketch to <outdir>/state-<process_id>.npz at shutdown.
Roles "leader-mismatch"/"follower-mismatch" exercise the connect-time
config handshake. Roles "leader-graphs"/"follower-graphs" (on the card)
run the lockstep warmup, which captures every decide, install, GLOBAL
step and read graph in both processes, then the traffic script, while a side thread in each process
keeps capturing a flat engine's warmup; they print LEADER-GRAPHS-OK and
FOLLOWER-GRAPHS-OK.

`traffic_script` is importable without JAX (tests import this file by
bare name), and runs against any engine with the mesh surface: the
port's MultiHostMeshEngine or MeshEngine, or the JAX package's MeshEngine.
"""

import os
import sys

import numpy as np

T0 = 1_700_000_000_000
# the traffic script starts this long after the legs' first decide pinned
# the epoch at T0 (the legs end ~90 s after it)
T_SCRIPT = T0 + 1_000_000
STORE = dict(rows=16, slots=1 << 8)
SKETCH = dict(rows=2, width=1 << 10)
BUCKETS = (16,)


def traffic_script(eng, n_shards: int, seed: int = 0xD1FF) -> list:
    """A fixed, seeded stream through a mesh engine whose clock epoch is
    pinned at T0 and whose store is empty: a way-saturated (shard,
    bucket) whose extra keys the sketch serves, decides of all four
    algorithms with duplicate keys, GLOBAL misses and clock steps, a
    sync_globals and an update_globals, two submits in flight, two
    GLOBAL hit applies and a promote of the sketch-served keys. Returns
    every output, in order, as numpy arrays."""
    from gubernator_tpu_torch.core.hashing import mix64
    from gubernator_tpu_torch.core.store import _BUCKET_SALT
    from gubernator_tpu_torch.parallel.sharded import owner_of_np

    rng = np.random.default_rng(seed)
    outs = []

    def keep(result):
        outs.extend(np.asarray(x) for x in result)

    cand = (np.arange(1, 1 << 18, dtype=np.uint64) << np.uint64(32)) | np.uint64(3)
    cell = owner_of_np(cand, n_shards).astype(np.int64) * STORE["slots"] + (
        mix64(cand ^ np.uint64(_BUCKET_SALT)) & np.uint64(STORE["slots"] - 1)
    ).astype(np.int64)
    same = cand[cell == cell[0]]
    fillers, tail = same[: STORE["rows"]], same[STORE["rows"] : STORE["rows"] + 8]
    nt = tail.shape[0]
    pool = rng.integers(1, 2**63, 6 * n_shards).astype(np.uint64)

    def batch(m):
        f = dict(
            key_hash=pool[rng.integers(0, pool.shape[0], m)],
            hits=rng.integers(0, 4, m).astype(np.int64),
            limit=rng.choice([2, 5, 50], m).astype(np.int64),
            duration=rng.choice([1000, 60_000], m).astype(np.int64),
            algo=rng.integers(0, 4, m).astype(np.int32),
            gnp=rng.random(m) < 0.1,
        )
        tail_f = dict(key_hash=tail, hits=np.ones(nt, np.int64), limit=np.full(nt, 4, np.int64),
                      duration=np.full(nt, 10_000, np.int64),
                      algo=(np.arange(nt) % 4).astype(np.int32), gnp=np.zeros(nt, bool))
        return {k: np.concatenate([f[k], tail_f[k]]) for k in f}

    now = T_SCRIPT
    nf = fillers.shape[0]
    ones = np.ones(nf, np.int64)
    keep(eng.decide_arrays(fillers, ones, ones * 1000, ones * 1_000_000_000,
                           np.zeros(nf, np.int32), np.zeros(nf, bool), now))
    for step in range(5):
        now += int(rng.choice([0, 3, 500, 7000]))
        f = batch(8 * n_shards)
        if step == 3:  # two batches in flight before either wait
            g = batch(8 * n_shards)
            h1 = eng.decide_submit(now=now, **f)
            h2 = eng.decide_submit(now=now + 1, **g)
            keep(eng.decide_wait(h1))
            keep(eng.decide_wait(h2))
            continue
        keep(eng.decide_arrays(now=now, **f))
        if step == 1:
            k = pool[:12]
            m = k.shape[0]
            eng.sync_globals(k, np.full(m, 5, np.int64), np.full(m, 60_000, np.int64), now,
                             algo=np.zeros(m, np.int32))
            eng.update_globals(key_hash=pool[12:24], limit=np.full(12, 9, np.int64),
                               remaining=np.arange(12, dtype=np.int64),
                               reset_time=np.full(12, now + 30_000, np.int64),
                               is_over=np.arange(12) % 5 == 0, now=now + 1)
    k = pool[-12:]
    for i in range(2):
        now += 2
        keep(eng.apply_global_hits(k, rng.integers(0, 3, 12).astype(np.int64),
                                   np.full(12, 7, np.int64), np.full(12, 60_000, np.int64),
                                   now, algo=rng.integers(0, 4, 12).astype(np.int32)))
    pk = np.concatenate([tail, pool[:8]])
    now += 5
    keep(eng.promote_from_sketch(pk, np.full(pk.shape[0], 4, np.int64),
                                 np.full(pk.shape[0], 10_000, np.int64), now))
    now += 5
    keep(eng.decide_arrays(now=now, **batch(8 * n_shards)))
    return outs


def run_group(nprocs: int, per: int, device: str, outdir, timeout: float,
              leader_role: str = "leader", follower_role: str = "follower"):
    """Spawn a leader and nprocs - 1 followers of `per` shards of `device`
    each (this file, one process a role); return (leader rc, leader
    output, follower rcs, follower outputs). One deadline covers every
    process: on expiry all are killed and an AssertionError carries every
    log."""
    import pathlib
    import subprocess
    import time

    from _util import free_ports

    root = pathlib.Path(__file__).resolve().parent.parent
    coord, *step_ports = free_ports(nprocs)
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def spawn(role, ports, pid):
        return subprocess.Popen(
            [sys.executable, __file__, role, f"127.0.0.1:{coord}", ports, str(pid),
             str(nprocs), str(per), device, str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root, env=env,
        )

    followers = [spawn(follower_role, str(p), i + 1) for i, p in enumerate(step_ports)]
    leader = spawn(leader_role, ",".join(map(str, step_ports)), 0)
    procs = [leader] + followers
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        raise AssertionError(
            "timeout\n" + "\n".join(f"process {i}:\n{log}" for i, log in enumerate(logs))
        ) from None
    return leader.returncode, outs[0], [f.returncode for f in followers], outs[1:]


def assert_ok(l_rc, l_out, f_rcs, f_outs) -> None:
    """Every leg passed in the leader, every follower exited cleanly, and
    the policy named its cross-process backend."""
    assert l_rc == 0 and "LEADER-OK" in l_out, (
        f"leader failed:\n{l_out}\nfollowers:\n" + "\n".join(f_outs)
    )
    for leg in ("GHITS-OK", "SKETCH-OK", "RING-OK"):
        assert leg in l_out, l_out
    for rc, out in zip(f_rcs, f_outs):
        assert rc == 0 and "FOLLOWER-OK" in out, f"follower failed:\n{out}"
    assert "multi-process over gloo" in l_out, l_out


def assert_mismatch_ok(l_rc, l_out, f_rcs, f_outs) -> None:
    """The mismatched hello failed loudly on both sides."""
    assert l_rc == 0 and "LEADER-MISMATCH-OK" in l_out, (
        f"leader:\n{l_out}\nfollowers:\n" + "\n".join(f_outs)
    )
    for rc, out in zip(f_rcs, f_outs):
        assert rc == 0 and "FOLLOWER-MISMATCH-OK" in out, f"follower:\n{out}"


def load_outputs(outdir, nprocs: int):
    """(the leader's script outputs, the store and the sketch with every
    process's shards stacked process-major)."""
    got = np.load(os.path.join(outdir, "responses.npz"))
    outs = [got[f"arr_{i}"] for i in range(len(got.files))]
    states = [np.load(os.path.join(outdir, f"state-{p}.npz")) for p in range(nprocs)]
    return (outs, np.concatenate([s["store"] for s in states]),
            np.concatenate([s["sketch"] for s in states]))


def assert_same_outputs(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64), err_msg=f"output {i}")


def _legs(eng, cfg, SK, n_shards, T0, ref_device):
    """The reference runner's leader legs, against the port's own flat
    engine and host twins."""
    from gubernator_tpu_torch.core.hashing import slot_hash_batch
    from gubernator_tpu_torch.parallel.sharded import TorchEngine, owner_of_np, pad_request_sharded

    # enough keys that EVERY shard owns some
    keys = [f"mh:{i}" for i in range(16 * n_shards)]
    kh = slot_hash_batch(keys)
    owners = owner_of_np(kh, n_shards)
    assert set(owners.tolist()) == set(range(n_shards)), sorted(set(owners.tolist()))

    n = len(keys)
    ones = np.ones(n, np.int64)
    limit = ones * 2
    dur = ones * 60_000
    algo = np.zeros(n, np.int32)
    gnp = np.zeros(n, bool)

    # cross-topology work line: padded per-shard sub-batch for this batch
    req, _o, _t, _g = pad_request_sharded(
        eng.sub_buckets, cfg.slots, n_shards, kh, ones, limit, dur, algo, gnp,
        with_groups=True,
    )
    print(f"TOPO shards={n_shards} b_sub={req.key_hash.shape[1]}", flush=True)

    # two charges then OVER, across every shard
    s1, _, r1, _ = eng.decide_arrays(kh, ones, limit, dur, algo, gnp, T0)
    assert (s1 == 0).all() and (r1 == 1).all(), (s1, r1)
    s2, _, r2, _ = eng.decide_arrays(kh, ones, limit, dur, algo, gnp, T0 + 1)
    assert (s2 == 0).all() and (r2 == 0).all(), (s2, r2)
    s3, _, r3, _ = eng.decide_arrays(kh, ones, limit, dur, algo, gnp, T0 + 2)
    assert (s3 == 1).all() and (r3 == 0).all(), (s3, r3)

    # GLOBAL gossip step: owner peek + cross-process sum + replica install
    eng.sync_globals(kh, limit, dur, T0 + 3)
    s4, _, r4, _ = eng.decide_arrays(
        kh, np.zeros(n, np.int64), limit, dur, algo, np.ones(n, bool), T0 + 4,
    )
    assert (s4 == 1).all(), s4  # every shard reports the OVER status

    # broadcast-install path (UpdatePeerGlobals receive side)
    eng.update_globals(
        kh, ones * 9, ones * 7, ones * (T0 + 60_000), np.zeros(n, bool), now=T0 + 5,
    )
    s5, l5, r5, _ = eng.decide_arrays(
        kh, np.zeros(n, np.int64), ones * 9, dur, algo, np.ones(n, bool), T0 + 6,
    )
    assert (r5 == 7).all() and (l5 == 9).all(), (l5, r5)

    # two submits in flight before either wait: followers dispatch and
    # post their gathers, the leader waits on them at fetch
    kh2 = kh * np.uint64(3) | np.uint64(1)
    h1 = eng.decide_submit(kh2, ones, ones * 2, dur, algo, gnp, T0 + 7)
    h2 = eng.decide_submit(kh2, ones, ones * 2, dur, algo, gnp, T0 + 8)
    s6, _, r6, _ = eng.decide_wait(h1)
    s7, _, r7, _ = eng.decide_wait(h2)
    assert (s6 == 0).all() and (r6 == 1).all(), (s6, r6)
    assert (s7 == 0).all() and (r7 == 0).all(), (s7, r7)

    # -- GLOBAL hits in one lockstep step, against the flat engine's decide
    ref = TorchEngine(cfg, buckets=(2048,), sketch=SK, device=ref_device)
    # sketch windows quantize epoch-relative: pin the epoch eng pinned at T0
    ref._engine_now(T0)
    kh3 = kh * np.uint64(5) | np.uint64(2)
    hits3 = (np.arange(n, dtype=np.int64) % 3) + 1
    lim3 = ones * 7
    for step in range(2):  # the second flush compounds on the same windows
        rr = ref.decide_arrays(kh3, hits3, lim3, dur, algo, gnp, T0 + 20 + step)
        mm = eng.apply_global_hits(kh3, hits3, lim3, dur, T0 + 20 + step)
        for a, b in zip(rr, mm):
            np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
    # replica-install leg: gnp peeks answer from the installed windows
    rp = ref.decide_arrays(kh3, np.zeros(n, np.int64), lim3, dur, algo, np.ones(n, bool), T0 + 22)
    mp = eng.decide_arrays(kh3, np.zeros(n, np.int64), lim3, dur, algo, np.ones(n, bool), T0 + 22)
    for a, b in zip(rp, mp):
        np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
    print("GHITS-OK", flush=True)

    # -- the sketch tier across processes: lockstep promotes vs the flat engine
    khp = (np.arange(1, 4 * n_shards + 1, dtype=np.uint64) << np.uint64(32)) | np.uint64(7)
    np_ = khp.shape[0]
    limsP = np.full(np_, 5, np.int64)
    dursP = np.full(np_, 60_000, np.int64)
    mt = eng.promote_from_sketch(khp, limsP, dursP, T0 + 30)
    rt = ref.promote_from_sketch(khp, limsP, dursP, T0 + 30)
    for a, b in zip(mt, rt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mt[0].all(), "first promote should install every key"
    mt2 = eng.promote_from_sketch(khp, limsP, dursP, T0 + 31)
    rt2 = ref.promote_from_sketch(khp, limsP, dursP, T0 + 31)
    assert not mt2[0].any() and not rt2[0].any(), (mt2[0], rt2[0])
    onesP = np.ones(np_, np.int64)
    sa = ref.decide_arrays(khp, onesP, limsP, dursP, np.zeros(np_, np.int32),
                           np.zeros(np_, bool), T0 + 32)
    sb = eng.decide_arrays(khp, onesP, limsP, dursP, np.zeros(np_, np.int32),
                           np.zeros(np_, bool), T0 + 32)
    for a, b in zip(sa, sb):
        np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
    print("SKETCH-OK", flush=True)

    # -- sliding + GCRA served by a way-saturated bucket's ring --------------
    from gubernator_tpu_torch.core.algorithms import (
        gcra_params,
        sketch_gcra_budget,
        sketch_sliding_budget,
    )
    from gubernator_tpu_torch.core.hashing import mix64
    from gubernator_tpu_torch.core.store import _BUCKET_SALT

    def shard_bucket(arr):
        o = owner_of_np(arr, n_shards)
        b = mix64(arr ^ np.uint64(_BUCKET_SALT)) & np.uint64(cfg.slots - 1)
        return o.astype(np.int64), b.astype(np.int64)

    prior = np.concatenate([kh, kh2, kh3, khp])
    po, pb = shard_bucket(prior)
    used = set(zip(po.tolist(), pb.tolist()))
    # two targets sharing one FREE (shard, bucket)
    cand = (np.arange(10_000_000, 10_040_000, dtype=np.uint64) << np.uint64(32)) | np.uint64(5)
    co, cb = shard_bucket(cand)
    free = [i for i in range(cand.shape[0]) if (int(co[i]), int(cb[i])) not in used]
    home = (int(co[free[0]]), int(cb[free[0]]))
    pair = [i for i in free if (int(co[i]), int(cb[i])) == home][:2]
    assert len(pair) == 2, "no bucket-sharing target pair found"
    k_sld, k_gcra = cand[pair[0]], cand[pair[1]]
    # way-saturate the home bucket: cfg.rows immortal fillers
    fcand = (np.arange(1, 400_000, dtype=np.uint64) << np.uint64(32)) | np.uint64(9)
    fo, fb = shard_bucket(fcand)
    fsel = np.flatnonzero((fo == home[0]) & (fb == home[1]))[: cfg.rows]
    assert fsel.shape[0] == cfg.rows, "filler search exhausted"
    fillers = fcand[fsel]
    nf = fillers.shape[0]
    onesF = np.ones(nf, np.int64)
    t = T0 + 40
    sF, _, _, _ = eng.decide_arrays(fillers, onesF, onesF * 1000, onesF * 1_000_000_000,
                                    np.zeros(nf, np.int32), np.zeros(nf, bool), t)
    assert (sF == 0).all(), sF

    I32_MAX = (1 << 31) - 1
    DUR, LIM = 10_000, 4
    epoch = T0 - 1  # pinned at the engine's first decide (T0)
    charges = {2: {}, 3: {}}
    windows = set()
    for dt in (1, 1, 1, 1, 1, 3000, 1, 1, 6000, 1, 1, 15_000,
               1, 1, 1, 1, 25_001, 1, 2, 3, 9_999, 1):
        t += dt
        e_now = t - epoch
        wid = e_now // DUR
        windows.add(wid)
        exp = {}
        for algo_id in (2, 3):
            cur = charges[algo_id].get(wid, 0)
            prev = charges[algo_id].get(wid - 1, 0)
            if algo_id == 2:
                budget, wend = sketch_sliding_budget(cur, prev, e_now, LIM, DUR)
                reset = epoch + wend
            else:
                budget, tatq = sketch_gcra_budget(cur, prev, e_now, LIM, DUR)
                T_, tau = gcra_params(LIM, DUR)
                tatq_c = min(tatq, I32_MAX)
                if budget >= 1:
                    reset = epoch + min(tatq_c + T_, I32_MAX)
                else:
                    reset = epoch + min(tatq_c + T_ - tau, I32_MAX)
            exp[algo_id] = (budget, reset)
        bkh = np.concatenate([fillers, [k_sld], [k_gcra]])
        bh = np.concatenate([np.zeros(nf, np.int64), [1, 1]])
        bl = np.full(nf + 2, LIM, np.int64)
        bl[:nf] = 1000
        bd = np.full(nf + 2, DUR, np.int64)
        bd[:nf] = 1_000_000_000
        ba = np.concatenate([np.zeros(nf, np.int32), np.asarray([2, 3], np.int32)])
        s, l, r, ts = eng.decide_arrays(bkh, bh, bl, bd, ba, np.zeros(nf + 2, bool), t)
        for row, algo_id in ((nf, 2), (nf + 1, 3)):
            budget, reset = exp[algo_id]
            charged = budget >= 1
            assert s[row] == (0 if charged else 1), (algo_id, t, s[row])
            assert r[row] == (budget - 1 if charged else 0), (algo_id, t)
            assert ts[row] == reset, (algo_id, t, int(ts[row]), reset)
            assert l[row] == LIM
            if charged:
                charges[algo_id][wid] = charges[algo_id].get(wid, 0) + 1
    assert len(windows) >= 3, "ring drive never crossed rotations"
    assert sum(charges[2].values()) > 0 and sum(charges[3].values()) > 0
    print("RING-OK", flush=True)


class _SideCaptures:
    """A thread that warms up (and so captures the decide graphs of) a
    flat engine on `device`, closes it and starts again, until stopped:
    captures that must survive whatever the rest of the process and the
    other processes do meanwhile. `stop()` returns the rounds it
    finished, after holding its last engine against an eager one."""

    def __init__(self, device: str, cfg):
        import threading

        self.device, self.cfg = device, cfg
        self.rounds, self.errors = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _engine(self, **kw):
        from gubernator_tpu_torch.core.engine import TorchEngine

        return TorchEngine(self.cfg, buckets=(64, 256), device=self.device, **kw)

    def _run(self):
        try:
            while True:
                eng = self._engine()
                eng.warmup(now=T0)
                assert (eng.graph_count, eng.graph_captures) == (4, 0), eng.graph_count
                if self._stop.is_set():
                    break
                eng.close()
                self.rounds += 1
            ref = self._engine(cuda_graphs=False)
            rng = np.random.default_rng(5)
            for step in range(4):
                m = 60 * (step + 1)
                args = (rng.integers(1, 2**63, m).astype(np.uint64), np.ones(m, np.int64),
                        np.full(m, 3, np.int64), np.full(m, 60_000, np.int64),
                        rng.integers(0, 4, m).astype(np.int32), np.zeros(m, bool), T0 + step)
                for a, b in zip(eng.decide_arrays(*args), ref.decide_arrays(*args)):
                    assert np.array_equal(a, b), step
            assert eng.graph_captures == 0
        except Exception as e:  # reported by stop()
            self.errors.append(repr(e))

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(120)
        assert not self._thread.is_alive() and not self.errors, self.errors
        assert self.rounds > 0, "the side thread finished no capture round"
        return self.rounds


def _save_state(eng, outdir: str, pid: int) -> None:
    np.savez(os.path.join(outdir, f"state-{pid}.npz"), store=eng.inner.store_numpy(),
             sketch=eng.inner.sketch_numpy())


def main():
    role, coordinator, step_ports, pid_s, nprocs_s, per_s, device, outdir = sys.argv[1:9]
    pid, nprocs, per = int(pid_s), int(nprocs_s), int(per_s)

    from gubernator_tpu_torch.core.sketches import SketchConfig
    from gubernator_tpu_torch.core.store import StoreConfig
    from gubernator_tpu_torch.parallel.multihost import (
        MultiHostMeshEngine,
        initialize_distributed,
        shutdown_distributed,
    )

    initialize_distributed(coordinator, num_processes=nprocs, process_id=pid)
    cfg = StoreConfig(**STORE)
    SK = SketchConfig(**SKETCH)
    devices = [device] * per
    followers = [f"127.0.0.1:{p}" for p in step_ports.split(",")]
    try:
        if role == "follower-mismatch":
            eng = MultiHostMeshEngine(cfg, buckets=(32,), devices=devices)  # leader: (16,)
            try:
                eng.follower_loop(f"127.0.0.1:{step_ports}")
            except RuntimeError as e:
                assert "config mismatch" in str(e), e
                print("FOLLOWER-MISMATCH-OK", flush=True)
                return
            raise SystemExit("follower accepted a mismatched leader config")

        if role == "leader-mismatch":
            try:
                MultiHostMeshEngine(cfg, followers=followers, buckets=BUCKETS, devices=devices)
            except RuntimeError as e:
                assert "config mismatch" in str(e), e
                print("LEADER-MISMATCH-OK", flush=True)
                return
            raise SystemExit("leader handshake accepted a mismatched follower")

        leader = role in ("leader", "leader-graphs")
        eng = MultiHostMeshEngine(
            cfg, followers=followers if leader else None, buckets=BUCKETS,
            sketch=SK, devices=devices,
        )
        # the 2-D ("host", "chip") form, process-major: this process holds
        # the contiguous global shards [pid * per, (pid + 1) * per)
        pol = eng.policy
        assert pol.spans_processes and pol.axes == ("host", "chip"), pol
        assert pol.shape == (nprocs, per) and eng.n == nprocs * per, pol
        assert pol.local_shards == range(pid * per, (pid + 1) * per), pol.local_shards
        print("POLICY", pol.describe(), flush=True)

        if role == "follower":
            eng.follower_loop(f"127.0.0.1:{step_ports}")
            _save_state(eng, outdir, pid)
            print("FOLLOWER-OK", flush=True)
            return

        if role in ("leader-graphs", "follower-graphs"):
            from gubernator_tpu_torch.core.engine import group_rungs

            side = _SideCaptures(device, cfg)
            if role == "follower-graphs":
                eng.follower_loop(f"127.0.0.1:{step_ports}")
            else:
                eng.warmup(now=T0)
                assert eng.graph_captures == 0, eng.graph_captures
                warmed = eng.graph_count
                outs = traffic_script(eng, eng.n)
                np.savez(os.path.join(outdir, "responses.npz"), *outs)
                print("GRAPHS", warmed, eng.graph_count, eng.graph_captures, flush=True)
                # the script's GLOBAL steps, installs and reads replayed the
                # warmup's graphs: a charge and an install graph a rung
                # (the parts all_reduced between), the reads at every rung
                assert (eng.program_captures, eng.first_use_captures) == (0, 0), (
                    eng.program_captures, eng.first_use_captures)
            rounds = side.stop()
            pairs = sum(len(group_rungs(r)) for r in eng.sub_buckets)
            # both processes captured the warmup's pairs, once a program
            assert eng.inner.graph_count >= 2 * pairs, eng.inner.graph_count
            # and its install, GLOBAL step halves and reads
            from gubernator_tpu_torch.parallel.sharded import READ_RUNGS

            want = 3 * len(eng.buckets) + 2 * len(READ_RUNGS)
            assert eng.program_graph_count == want, (eng.program_graph_count, want)
            _save_state(eng, outdir, pid)
            if role == "leader-graphs":
                eng.close()
            print(f"{role.upper()}-OK side_rounds={rounds}", flush=True)
            return

        _legs(eng, cfg, SK, eng.n, T0, device)
        eng.reset()
        outs = traffic_script(eng, eng.n)
        np.savez(os.path.join(outdir, "responses.npz"), *outs)
        _save_state(eng, outdir, pid)
        eng.close()
        print("LEADER-OK", flush=True)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
