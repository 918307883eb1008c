"""The port's native hasher and host prep (native/guberhash.cc, built with
g++ at first use into gubernator_tpu_torch/_build/, bound by
native/hashlib_native.py) on the CPU.

Mirrors the JAX package's native tests (tests/test_hashing.py,
tests/test_prep_native.py, tests/test_prep_pipeline.py), which skip
where the JAX package's own library is not built; the port builds its
copy, so they run here:

- the source is a byte-for-byte copy of the JAX package's; the build is
  keyed and reused; a failed build is logged and falls back to blake2b-8;
- XXH64 on the published vectors, crc32 against zlib, and the edge's
  slot hash (name + "_" + key, edge.cc's seed) equal to `hash_batch`;
- every native prep function byte-identical to the port's numpy twin:
  the presorts, `pad_request_sorted`'s fused prep and marshal, the
  arrival prep `prep_run`, the merge (`merge_runs_native`, whose order
  is a stable argsort of the concatenated runs), the engine's
  `merge_prepped` and the responses' unpermute;
- the prep thread pool bit-identical at every width, the buffer ring's
  lifetime, a deep pipeline of decides against the numpy engine, and a
  forked child's prep running inline instead of hanging;
- the GEB client hashing with the native library and loading no torch.

Inputs come from numpy seeds; tolerance is zero.
"""

import logging
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import gubernator_tpu_torch.core.engine as eng
import gubernator_tpu_torch.parallel.sharded as sharded
import gubernator_tpu_torch.serve.prep as prep_mod
from gubernator_tpu_torch.core import hashing
from gubernator_tpu_torch.core.store import (
    COUNTER_MAX,
    MAX_DURATION_MS,
    TIME_FLOOR,
    StoreConfig,
    group_sort_key_np,
)
from gubernator_tpu_torch.native import edge_build, load_hashlib
from gubernator_tpu_torch.parallel.sharded import TorchEngine

hn = load_hashlib()
REPO = Path(__file__).resolve().parent.parent
CLIP = (-COUNTER_MAX, COUNTER_MAX, TIME_FLOOR, MAX_DURATION_MS)
FIELDS = ("key_hash", "hits", "limit", "duration", "algo", "gnp")


def _numpy_only(mp):
    """The port's numpy twins only: the engine, the merge and TorchEngine
    see no native library."""
    for mod in (eng, prep_mod, sharded):
        mp.setattr(mod, "_native", lambda: None)


def _traffic(rng, n, pool=50_000):
    zipf = rng.zipf(1.2, size=n) % pool
    kh = (zipf.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(0xABCD)
    return (
        kh,
        rng.integers(-(2**40), 2**40, n),  # hits: exercises clipping
        rng.integers(0, 2**40, n),
        rng.integers(-5, 2**40, n),  # duration: below TIME_FLOOR too
        rng.integers(0, 4, n).astype(np.int32),
        rng.integers(0, 2, n).astype(bool),
    )


def _group(rng, n, pool):
    return dict(
        key_hash=rng.choice(pool, n),
        hits=rng.integers(-(2**40), 2**40, n),
        limit=rng.integers(0, 2**40, n),
        duration=rng.integers(-5, 2**40, n),
        algo=rng.integers(0, 4, n).astype(np.int32),
        gnp=rng.random(n) < 0.3,
    )


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


# -- the library ---------------------------------------------------------------


def test_source_is_the_jax_packages_byte_for_byte_and_builds_once():
    ref = REPO / "gubernator_tpu" / "native" / "guberhash.cc"
    assert edge_build.HASHER_SOURCE.read_bytes() == ref.read_bytes()
    assert hn is not None and hashing.using_native_hash()
    so = Path(hn._SO)
    assert so.parent == edge_build.BUILD_DIR and so.name.startswith("libguberhash-")
    assert edge_build.build_hasher() == so  # up to date: no second build
    assert so.with_name(so.name + ".log").is_file()
    # the reference's Makefile flags, and the two headers the copy leaves
    # to its includes' includes (g++ 13's libstdc++ no longer pulls them in)
    assert edge_build.HASHER_FLAGS[:5] == ("-O3", "-fPIC", "-shared", "-Wall", "-pthread")
    assert edge_build.HASHER_FLAGS[5:] == ("-include", "cstdio", "-include", "cstdlib")


def test_failed_build_warns_and_falls_back_to_blake2b(tmp_path):
    """Not silent: a library that does not build logs a WARNING carrying
    the compiler's output, and the store and the client hash blake2b-8."""
    code = f"""
import logging, sys
logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
from gubernator_tpu_torch.native import edge_build
edge_build.BUILD_DIR = __import__("pathlib").Path({str(tmp_path)!r})
edge_build.HASHER_FLAGS = ("-O3", "-include", "/nonexistent/header.h", "-shared")
from gubernator_tpu_torch.core import hashing
from gubernator_tpu_torch import client_geb
assert not hashing.using_native_hash() and not hashing.slot_hash_is_xxh64()
assert not client_geb.client_hash_is_native()
assert int(hashing.slot_hash_batch(["a_b"])[0]) == hashing._slot_hash_py("a_b")
print("FALLBACK-OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FALLBACK-OK" in r.stdout
    assert "WARNING" in r.stderr and "g++ failed" in r.stderr
    assert "nonexistent/header.h" in r.stderr  # the compiler's own words
    # no half-written library (the build's lock file stays)
    assert [p.suffix for p in tmp_path.glob("libguberhash-*")] == [".lock"]


# -- hashing -------------------------------------------------------------------


def test_native_matches_known_xxh64_vectors_and_crc32():
    # published XXH64 seed-0 vectors
    v = hn.hash_batch_seed(["", "a", "abc"], 0)
    assert [int(x) for x in v] == [
        0xEF46DB3751D8E999, 0xD24EC4F1A98C6E5B, 0x44BC2CF5AD770999,
    ]
    # a >= 32-byte input exercises the 4-lane stripe and merge rounds
    long_key = "0123456789abcdef0123456789abcdef0123456789"
    assert int(hn.hash_batch_seed([long_key], 7)[0]) == 0x9CDB6129259B938E
    keys = ["a", "abc", "gubernator_tpu", ""]
    crc = hn.crc32_batch(keys)
    for i, k in enumerate(keys):
        assert int(crc[i]) == zlib.crc32(k.encode()) == hashing.ring_hash(k)


def test_slot_hash_batch_is_native_and_consistent_with_single():
    keys = [f"k:{i}" for i in range(100)] + ["", "ünï_cødé"]
    batch = hashing.slot_hash_batch(keys)
    assert batch.dtype == np.uint64
    np.testing.assert_array_equal(batch, hn.hash_batch(keys))
    for i in (0, 17, 99, 101):
        assert hashing.slot_hash(keys[i]) == int(batch[i])
    wide = [f"name_{i}_account:{i}" for i in range(50_000)]
    assert len(set(hashing.slot_hash_batch(wide).tolist())) == len(wide)


def _xxh64_py(data: bytes, seed: int) -> int:
    """XXH64 from its specification, in Python: the independent twin of
    guberhash.cc's and edge.cc's."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5, M = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5, (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def rnd(acc, lane):
        return (rotl((acc + lane * P2) & M, 31) * P1) & M

    def merge(acc, val):
        return ((acc ^ rnd(0, val)) * P1 + P4) & M

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed & M, (seed - P1) & M]
        while i + 32 <= n:
            for j in range(4):
                v[j] = rnd(v[j], int.from_bytes(data[i + 8 * j:i + 8 * j + 8], "little"))
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
        for x in v:
            h = merge(h, x)
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, int.from_bytes(data[i:i + 8], "little")), 27) * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (int.from_bytes(data[i:i + 4], "little") * P1) & M, 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = (rotl(h ^ (data[i] * P5) & M, 11) * P1) & M
        i += 1
    h = ((h ^ (h >> 33)) * P2) & M
    h = ((h ^ (h >> 29)) * P3) & M
    return h ^ (h >> 32)


def test_slot_hash_equals_the_edges_prehash():
    """edge.cc hashes name + "_" + key with kSlotHashSeed (edge.cc:98-175);
    the store's slot hash of the same joined key must give the same bits,
    or an edge fast frame lands in another row than the string path's.
    The seed is read from edge.cc itself and the hash from the spec."""
    src = (REPO / "gubernator_tpu_torch" / "native" / "edge" / "edge.cc").read_text()
    line = next(ln for ln in src.splitlines() if "kSlotHashSeed =" in ln)
    seed = int(line.split("=")[1].split("ULL")[0].strip(), 16)
    assert seed == hn._SEED
    rng = np.random.default_rng(9)
    keys = [f"wide-{i}-é{i % 7}_" + "x" * int(rng.integers(0, 70)) for i in range(64)]
    want = [_xxh64_py(k.encode(), seed) for k in keys]
    assert [int(x) for x in hashing.slot_hash_batch(keys)] == want


# -- presorts ------------------------------------------------------------------


def test_native_presort_matches_numpy():
    """Both native paths (the counting fast path up to 2^16 buckets, the
    radix beyond) order exactly as the stable argsort of the sort key."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 1000, 16384):
        for buckets in (1 << 10, 1 << 15, 1 << 16, 1 << 21):
            kh = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
            if n > 10:
                kh[n // 2:] = kh[: n - n // 2]  # duplicates: stability matters
            want = np.argsort(group_sort_key_np(kh, buckets), kind="stable")
            assert (hn.presort(kh, buckets) == want).all(), (n, buckets)
            _same(eng._presort(kh, buckets), eng._np_presort(kh, buckets), "presort")


def test_native_presort_grouped_matches_numpy():
    rng = np.random.default_rng(5)
    for n in (0, 1, 9, 1000, 8192):
        for buckets in (1 << 10, 1 << 16, 1 << 21):
            kh = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
            if n > 10:
                kh[n // 2:] = kh[: n - n // 2]
            o1, g1, l1, G1 = eng._np_presort_grouped(kh, buckets)
            o2, g2, l2, G2 = hn.presort_grouped(kh, buckets)
            assert G1 == G2, (n, buckets)
            assert (o2 == o1).all() and (g2[:n] == g1).all() and (l2[:G1] == l1).all()
            # one shard of the sharded presort is the flat presort
            so, counts = hn.presort_sharded(kh, buckets, 1)
            assert (so == o1).all() and counts.tolist() == [n]


# -- fused prep and marshal ----------------------------------------------------


def _pad_numpy(monkeypatch, *args):
    with monkeypatch.context() as mp:
        _numpy_only(mp)
        return eng.pad_request_sorted(*args, with_groups=True)


@pytest.mark.parametrize("n,slots", [(4096, 1 << 15), (1, 1 << 12), (5000, 1 << 12),
                                     (300, 1 << 10), (32768, 1 << 20)])
def test_pad_request_sorted_native_matches_numpy(monkeypatch, n, slots):
    """The fused one-call prep (prep_threads() > 1, as here) and, with one
    prep thread, the native presort + marshal, against the numpy path."""
    rng = np.random.default_rng(n + slots)
    arrays = _traffic(rng, n)
    ladder = eng.buckets_for_limit(32768)
    req_np, order_np, groups_np = _pad_numpy(monkeypatch, ladder, slots, *arrays)
    assert hn.prep_threads() > 1  # the fused path is the one taken
    for threads in (hn.prep_threads(), 1):
        monkeypatch.setattr(hn, "prep_threads", lambda t=threads: t)
        req, order, groups = eng.pad_request_sorted(ladder, slots, *arrays,
                                                    with_groups=True)
        _same(order, order_np, f"order/{threads}")
        for f in req._fields:
            _same(getattr(req, f), getattr(req_np, f), f"req.{f}/{threads}")
        for f in groups._fields:
            _same(getattr(groups, f), getattr(groups_np, f), f"groups.{f}/{threads}")
    # without groups: presort + marshal
    r1, o1 = eng.pad_request_sorted(ladder, slots, *arrays)
    with monkeypatch.context() as mp:
        _numpy_only(mp)
        r2, o2 = eng.pad_request_sorted(ladder, slots, *arrays)
    _same(o1, o2, "order (no groups)")
    for f in r1._fields:
        _same(getattr(r1, f), getattr(r2, f), f"req.{f} (no groups)")


def test_prep_run_matches_numpy_twin(monkeypatch):
    rng = np.random.default_rng(17)
    for n in (1, 2, 63, 1000, 4096):
        g = _group(rng, n, rng.integers(1, 2**63, max(n // 3, 2), np.int64).astype(np.uint64))
        got = eng.prep_run_single(g, 1 << 14)
        with monkeypatch.context() as mp:
            _numpy_only(mp)
            want = eng.prep_run_single(g, 1 << 14)
        assert got["n"] == want["n"] == n
        for k in ("skey", "order", "counts"):
            _same(got[k], want[k], k)
        for k in FIELDS:
            _same(got["fields"][k], want["fields"][k], f"fields.{k}")


def test_merge_order_equals_stable_argsort():
    """guber_merge_runs' order is np.argsort(concat, kind='stable') of the
    groups' caller-order keys: ties across runs resolve in run order,
    empty and one-row runs included."""
    rng = np.random.default_rng(0xA11)
    for _trial in range(40):
        pool = rng.integers(1, 2**63, int(rng.integers(2, 30)), np.int64).astype(np.uint64)
        groups = [_group(rng, int(rng.integers(1, 40)), pool)
                  for _ in range(int(rng.integers(1, 9)))]
        runs = [hn.prep_run(g, 1 << 10, 1, *CLIP) for g in groups]
        n = sum(r["n"] for r in runs)
        m = hn.merge_runs_native(runs, n)
        cat = np.concatenate([group_sort_key_np(g["key_hash"], 1 << 10) for g in groups])
        want = np.argsort(cat, kind="stable")
        _same(m["order"][:n], want.astype(np.int32), "order")
        _same(m["skey"], cat[want], "skey")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_runs_and_merge_prepped_match_numpy(monkeypatch, seed):
    """serve/prep.merge_runs (flat) and TorchEngine.merge_prepped (padded,
    with the group stream) byte-identical on the native merge and on the
    numpy twin, and both equal to pad_request_sorted of the concatenation."""
    rng = np.random.default_rng(0xBEEF + seed)
    ladder = (64, 256, 1024)
    e = TorchEngine(StoreConfig(rows=4, slots=1 << 10), buckets=ladder, device="cpu")
    for _trial in range(8):
        pool = rng.integers(1, 2**63, 64, np.int64).astype(np.uint64)
        groups = [_group(rng, int(rng.integers(1, 200)), pool)
                  for _ in range(int(rng.integers(1, 7)))]
        runs = [eng.prep_run_single(g, 1 << 10) for g in groups]
        m_nat, merged_nat = prep_mod.merge_runs(runs), e.merge_prepped(runs)
        with monkeypatch.context() as mp:
            _numpy_only(mp)
            runs_np = [eng.prep_run_single(g, 1 << 10) for g in groups]
            m_np, merged_np = prep_mod.merge_runs(runs_np), e.merge_prepped(runs_np)
            cat = {k: np.concatenate([g[k] for g in groups]) for k in FIELDS}
            req_ref, order_ref, grp_ref = eng.pad_request_sorted(
                ladder, 1 << 10, *(cat[k] for k in FIELDS), with_groups=True)
        for k in ("skey", "order", "counts"):
            _same(m_nat[k], m_np[k], f"merge_runs {k}")
        for k in FIELDS:
            _same(m_nat["fields"][k], m_np["fields"][k], f"merge_runs fields.{k}")
        for merged in (merged_nat, merged_np):
            _same(merged["order"], order_ref, "merge_prepped order")
            for f in req_ref._fields:
                _same(getattr(merged["req"], f), getattr(req_ref, f), f"req.{f}")
            for f in grp_ref._fields:
                _same(getattr(merged["groups"], f), getattr(grp_ref, f), f"groups.{f}")


def test_unpermute_matches_numpy():
    rng = np.random.default_rng(23)
    for n, B in ((1, 64), (50, 64), (1000, 1024)):
        order = np.empty(B, np.int32)
        order[:n] = rng.permutation(n)
        order[n:] = np.arange(n, B)
        stack = rng.integers(-(2**31), 2**31 - 1, (4, B), dtype=np.int64).astype(np.int32)
        got = hn.unpermute_i32(stack, order, n)
        want = eng.unpermute_responses(order, tuple(stack))
        for a in range(4):
            _same(got[a][:n], want[a][:n], f"column {a}")


# -- pool, ring, pipeline, fork --------------------------------------------------


@pytest.mark.parametrize("threads", ["2", "7"])
def test_prep_thread_pool_bit_identity(threads):
    """GUBER_PREP_THREADS is read when the pool starts, so each width runs
    in a subprocess; the outputs must hash alike at every width."""
    code = """
import hashlib, sys
import numpy as np
from gubernator_tpu_torch.native import load_hashlib
from gubernator_tpu_torch.core.store import COUNTER_MAX, MAX_DURATION_MS, TIME_FLOOR
hn = load_hashlib()
assert hn.prep_threads() == int(sys.argv[1]), hn.prep_threads()
rng = np.random.default_rng(99)
n = 20000
zipf = rng.zipf(1.2, size=n) % 50_000
kh = (zipf.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(0xF00)
cols = (kh, rng.integers(-2**40, 2**40, n), rng.integers(0, 2**40, n),
        rng.integers(-5, 2**40, n), rng.integers(0, 4, n).astype(np.int32),
        rng.integers(0, 2, n).astype(bool))
clip = (-COUNTER_MAX, COUNTER_MAX, TIME_FLOOR, MAX_DURATION_MS)
d = hashlib.sha256()
for shards in (1, 8):
    r = hn.prep_sharded(*cols, 1 << 15, shards, np.asarray([4096, 32768], np.int64), 0, *clip)
    for a in (r[0], r[2], r[3]["key_hash"], r[3]["hits"], r[3]["valid"],
              r[4]["leader_pos"], r[4]["end_pos"], r[4]["group_id"]):
        d.update(np.ascontiguousarray(a).tobytes())
print(d.hexdigest())
"""
    env = dict(os.environ, GUBER_PREP_THREADS="1", PYTHONPATH=str(REPO))
    base = subprocess.run([sys.executable, "-c", code, "1"], capture_output=True,
                          text=True, env=env, timeout=120)
    assert base.returncode == 0, base.stderr[-800:]
    env["GUBER_PREP_THREADS"] = threads
    got = subprocess.run([sys.executable, "-c", code, threads], capture_output=True,
                         text=True, env=env, timeout=120)
    assert got.returncode == 0, got.stderr[-800:]
    assert got.stdout.strip() == base.stdout.strip(), f"threads={threads} diverged"


def test_prep_buffer_ring_lifetime():
    """A fused prep's outputs survive gens - 1 further calls on the same
    thread and are reused at the gens'th (set_prep_generations)."""
    rng = np.random.default_rng(11)
    rungs = np.asarray([1024], np.int64)
    a1, a2 = _traffic(rng, 500), _traffic(rng, 500)
    try:
        hn.set_prep_generations(3)
        r1 = hn.prep_sharded(*a1, 1 << 12, 1, rungs, 0, *CLIP)
        kh1 = r1[3]["key_hash"].copy()
        for _ in range(2):
            hn.prep_sharded(*a2, 1 << 12, 1, rungs, 0, *CLIP)
            np.testing.assert_array_equal(r1[3]["key_hash"], kh1)
        hn.prep_sharded(*a2, 1 << 12, 1, rungs, 0, *CLIP)  # reuses r1's generation
        assert not np.array_equal(r1[3]["key_hash"], kh1)
    finally:
        hn.set_prep_generations(2)


def test_deep_pipeline_of_decides_matches_the_numpy_engine(monkeypatch):
    """Eight batches submitted before any wait, through the fused prep and
    its buffer ring (two generations, so views are reused while handles
    are outstanding), then waited in reverse: every response equals the
    numpy engine's, so no handle holds a view of the ring."""
    rng = np.random.default_rng(29)
    ladder = (64, 256, 1024)
    batches = [_traffic(rng, int(rng.integers(1, 1000)), pool=300) for _ in range(8)]
    now = 1_700_000_000_000

    def run(native: bool):
        e = TorchEngine(StoreConfig(rows=8, slots=1 << 9), buckets=ladder, device="cpu")
        with monkeypatch.context() as mp:
            if not native:
                _numpy_only(mp)
            handles = [e.decide_submit(*b, now + i) for i, b in enumerate(batches)]
            outs = [e.decide_wait(h) for h in reversed(handles)]
        return outs, e.store.data.numpy().copy(), e.stats.snapshot()

    assert hn.prep_threads() > 1
    got, got_store, got_stats = run(True)
    want, want_store, want_stats = run(False)
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            _same(x, y, f"batch {i}")
    _same(got_store, want_store, "store")
    assert got_stats == want_stats


def test_prep_pool_fork_safety():
    """A forked child inherits a multi-lane pool with no worker threads;
    the atfork guard makes its prep run inline instead of hanging."""
    code = """
import os
import numpy as np
from gubernator_tpu_torch.native import load_hashlib
from gubernator_tpu_torch.core.store import COUNTER_MAX, MAX_DURATION_MS, TIME_FLOOR
hn = load_hashlib()
assert hn.prep_threads() == 4
rng = np.random.default_rng(5)
n = 4000
kh = rng.integers(1, 2**63, n).astype(np.uint64)
cols = (kh, np.ones(n, np.int64), np.ones(n, np.int64) * 10, np.ones(n, np.int64) * 1000,
        np.zeros(n, np.int32), np.zeros(n, bool))
clip = (-COUNTER_MAX, COUNTER_MAX, TIME_FLOOR, MAX_DURATION_MS)
rungs = np.asarray([4096], np.int64)
parent_order = hn.prep_sharded(*cols, 1 << 12, 4, rungs, 0, *clip)[0].copy()
pid = os.fork()
if pid == 0:
    r = hn.prep_sharded(*cols, 1 << 12, 4, rungs, 0, *clip)
    os._exit(0 if np.array_equal(r[0], parent_order) else 3)
_, status = os.waitpid(pid, 0)
assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0, status
print("FORK-OK")
"""
    env = dict(os.environ, GUBER_PREP_THREADS="4", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=60)
    assert out.returncode == 0, out.stderr[-800:]
    assert "FORK-OK" in out.stdout


# -- the GEB client ------------------------------------------------------------------


def test_client_hash_is_native_and_loads_no_torch():
    code = """
import sys
from gubernator_tpu_torch import client_geb
assert client_geb.client_hash_is_native()
from gubernator_tpu_torch.native import load_hashlib
keys = ["a_b", "name_key", ""]
assert (client_geb.client_hash_batch(keys) == load_hashlib().hash_batch(keys)).all()
bad = [m for m in sys.modules if m == "torch" or m.startswith(("torch.", "jax", "gubernator_tpu."))]
assert not bad, bad
print("CLIENT-OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-800:]
    assert "CLIENT-OK" in r.stdout


def test_boot_line_names_the_native_prep_and_the_slot_hash(caplog):
    """Server.start logs the native prep's width and the slot hash in
    use, as the JAX daemon logs its native prep line."""
    import asyncio

    from _util import free_ports
    from gubernator_tpu_torch.serve.config import config_from_env
    from gubernator_tpu_torch.serve.server import Server

    g, h = free_ports(2)
    conf = config_from_env({"GUBER_GRPC_ADDRESS": f"127.0.0.1:{g}",
                            "GUBER_HTTP_ADDRESS": f"127.0.0.1:{h}",
                            "GUBER_STORE_MIB": "4"})

    async def boot():
        srv = Server(conf, device="cpu")
        await srv.start()
        await srv.stop()

    with caplog.at_level(logging.INFO):
        asyncio.run(boot())
    line = next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("native prep:"))
    assert line == f"native prep: {hn.prep_threads()} thread(s) (GUBER_PREP_THREADS), " \
                   "slot hash XXH64"
