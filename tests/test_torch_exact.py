"""The port's exact backend against the JAX package's, on the CPU.

The port carries its own copies of the host LRU (core/cache.py), the exact
oracle (core/oracle.py) and `ExactBackend` (serve/backends.py). Here:

- each case of tests/test_oracle.py runs on both packages: the reference's
  assertions hold on the port, and every response the scenario observes is
  identical between the two (tolerance zero, integer math);
- `ExactBackend.decide` (plain and GLOBAL-non-owner rows), `decide_chain`
  and `snapshot_read` take one seeded stream on both packages and answer
  identically, leaving identical caches (keys, order, expiry, values);
- an `Instance(ExactBackend)` on a one-node ring takes the same caller
  groups on both packages under one pinned clock, through the batcher's
  inline path (no queue, no thread hop), and answers identically.

Inputs come from numpy seeds.
"""

import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import gubernator_tpu.api.types as j_types
import gubernator_tpu.core.cache as j_cache
import gubernator_tpu.core.oracle as j_oracle
import gubernator_tpu.serve.backends as j_backends
import gubernator_tpu.serve.config as j_config
import gubernator_tpu.serve.instance as j_instance
import gubernator_tpu_torch.api.types as t_types
import gubernator_tpu_torch.core.cache as t_cache
import gubernator_tpu_torch.core.oracle as t_oracle
import gubernator_tpu_torch.serve.backends as t_backends
import gubernator_tpu_torch.serve.config as t_config
import gubernator_tpu_torch.serve.instance as t_instance

J = SimpleNamespace(
    types=j_types, cache=j_cache, oracle=j_oracle, backends=j_backends,
    config=j_config, instance=j_instance,
)
T = SimpleNamespace(
    types=t_types, cache=t_cache, oracle=t_oracle, backends=t_backends,
    config=t_config, instance=t_instance,
)

T0 = 1_700_000_000_000
ADDR = "127.0.0.1:7981"


def _resp(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))


def _value(v):
    """A cached value as plain data (the two packages' classes differ)."""
    return (type(v).__name__, tuple(
        int(x) if isinstance(x, int) else x
        for x in (dataclasses.astuple(v) if dataclasses.is_dataclass(v) else (v,))
    ))


def _cache_state(cache):
    return (
        [(k, rec.expire_at, _value(rec.value)) for k, rec in cache._data.items()],
        dataclasses.astuple(cache.stats()),
    )


def _both(scenario):
    """Run `scenario(P)` on the port and on the JAX package: the asserts
    inside hold on each, and what each observes is identical."""
    got = scenario(T)
    want = scenario(J)
    assert got == want
    return got


def _req(P, **kw):
    kw.setdefault("name", "test")
    kw.setdefault("unique_key", "account:1234")
    return P.types.RateLimitReq(**kw)


# -- tests/test_oracle.py, on both packages ------------------------------------


def test_over_the_limit():
    def run(P):
        S = P.types.Status
        cache = P.cache.LRUCache()
        seen = []
        for remaining, status in [(1, S.UNDER_LIMIT), (0, S.UNDER_LIMIT), (0, S.OVER_LIMIT)]:
            rl = P.oracle.token_bucket(
                cache, _req(P, hits=1, limit=2, duration=P.types.SECOND), now=1_000_000
            )
            assert (rl.remaining, rl.status, rl.limit) == (remaining, status, 2)
            assert rl.reset_time != 0
            seen.append(_resp(rl))
        return seen

    _both(run)


def test_token_bucket_window_reset():
    def run(P):
        S = P.types.Status
        cache = P.cache.LRUCache()
        r = _req(P, hits=1, limit=2, duration=5 * P.types.MILLISECOND)
        seen = []
        for dt, want in ((0, (1, S.UNDER_LIMIT)), (0, (0, S.UNDER_LIMIT)), (6, (1, S.UNDER_LIMIT))):
            rl = P.oracle.token_bucket(cache, r, now=1_000_000 + dt)
            assert (rl.remaining, rl.status) == want
            seen.append(_resp(rl))
        return seen

    _both(run)


def test_leaky_bucket_drain():
    def run(P):
        S = P.types.Status
        cache = P.cache.LRUCache()
        t = 1_000_000
        seen = []
        for hits, advance, want_rem, want_status in [
            (5, 0, 0, S.UNDER_LIMIT),
            (1, 0, 0, S.OVER_LIMIT),
            (1, 10, 0, S.UNDER_LIMIT),
            (1, 20, 1, S.UNDER_LIMIT),
        ]:
            t += advance
            rl = P.oracle.leaky_bucket(
                cache, _req(P, hits=hits, limit=5, duration=50 * P.types.MILLISECOND), now=t
            )
            assert (rl.status, rl.remaining, rl.limit) == (want_status, want_rem, 5)
            seen.append(_resp(rl))
        return seen

    _both(run)


def test_zero_duration_and_zero_limit():
    def run(P):
        S = P.types.Status
        cache = P.cache.LRUCache()
        a = P.oracle.token_bucket(cache, _req(P, hits=1, limit=10, duration=0), now=1_000_000)
        assert a.status == S.UNDER_LIMIT
        b = P.oracle.token_bucket(
            cache, _req(P, unique_key="account:12345", hits=1, limit=0, duration=10000),
            now=1_000_000,
        )
        assert b.status == S.OVER_LIMIT
        return [_resp(a), _resp(b)]

    _both(run)


def test_token_peek_does_not_charge():
    def run(P):
        cache = P.cache.LRUCache()
        sec = P.types.SECOND
        seen = [_resp(P.oracle.token_bucket(cache, _req(P, hits=1, limit=5, duration=sec), now=1_000_000))]
        peek = _req(P, hits=0, limit=5, duration=sec)
        for _ in range(2):
            rl = P.oracle.token_bucket(cache, peek, now=1_000_000)
            assert rl.remaining == 4
            seen.append(_resp(rl))
        return seen

    _both(run)


def test_token_over_limit_not_persisted():
    def run(P):
        S = P.types.Status
        sec = P.types.SECOND
        cache = P.cache.LRUCache()
        P.oracle.token_bucket(cache, _req(P, hits=1, limit=100, duration=sec), now=1_000_000)
        a = P.oracle.token_bucket(cache, _req(P, hits=1000, limit=100, duration=sec), now=1_000_000)
        assert (a.status, a.remaining) == (S.OVER_LIMIT, 99)
        b = P.oracle.token_bucket(cache, _req(P, hits=99, limit=100, duration=sec), now=1_000_000)
        assert (b.status, b.remaining) == (S.UNDER_LIMIT, 0)
        return [_resp(a), _resp(b)]

    _both(run)


def test_token_sticky_over_on_oversized_creation():
    def run(P):
        S = P.types.Status
        sec = P.types.SECOND
        cache = P.cache.LRUCache()
        a = P.oracle.token_bucket(cache, _req(P, hits=10, limit=5, duration=sec), now=1_000_000)
        assert (a.status, a.remaining) == (S.OVER_LIMIT, 5)
        b = P.oracle.token_bucket(cache, _req(P, hits=2, limit=5, duration=sec), now=1_000_000)
        assert (b.status, b.remaining) == (S.OVER_LIMIT, 3)
        return [_resp(a), _resp(b)]

    _both(run)


def test_leaky_peek_at_empty_reports_over():
    def run(P):
        sec = P.types.SECOND
        cache = P.cache.LRUCache()
        P.oracle.leaky_bucket(cache, _req(P, hits=5, limit=5, duration=sec), now=1_000_000)
        rl = P.oracle.leaky_bucket(cache, _req(P, hits=0, limit=5, duration=sec), now=1_000_000)
        assert rl.status == P.types.Status.OVER_LIMIT
        assert rl.reset_time != 0
        return [_resp(rl)]

    _both(run)


def test_leaky_reset_time_zero_under_limit():
    def run(P):
        cache = P.cache.LRUCache()
        rl = P.oracle.leaky_bucket(
            cache, _req(P, hits=1, limit=5, duration=P.types.SECOND), now=1_000_000
        )
        assert (rl.status, rl.reset_time) == (P.types.Status.UNDER_LIMIT, 0)
        return [_resp(rl)]

    _both(run)


def test_leaky_refused_request_advances_timestamp():
    def run(P):
        S = P.types.Status
        cache = P.cache.LRUCache()
        now = 1_000_000
        P.oracle.leaky_bucket(cache, _req(P, hits=5, limit=5, duration=50), now=now)
        seen = []
        for dt, want in ((9, S.OVER_LIMIT), (18, S.OVER_LIMIT), (29, S.UNDER_LIMIT)):
            rl = P.oracle.leaky_bucket(cache, _req(P, hits=1, limit=5, duration=50), now=now + dt)
            assert rl.status == want
            seen.append(_resp(rl))
        assert seen[-1][2] == 0
        return seen

    _both(run)


def test_algorithm_switch_recreates_as_token():
    def run(P):
        sec = P.types.SECOND
        cache = P.cache.LRUCache()
        P.oracle.leaky_bucket(cache, _req(P, hits=1, limit=5, duration=sec), now=1_000_000)
        a = P.oracle.token_bucket(cache, _req(P, hits=1, limit=5, duration=sec), now=1_000_000)
        assert a.remaining == 4
        cache = P.cache.LRUCache()
        P.oracle.token_bucket(cache, _req(P, hits=3, limit=5, duration=sec), now=1_000_000)
        b = P.oracle.leaky_bucket(cache, _req(P, hits=1, limit=5, duration=sec), now=1_000_000)
        assert b.remaining == 4 and b.reset_time != 0
        return [_resp(a), _resp(b)]

    _both(run)


def test_dispatch_invalid_algorithm():
    def run(P):
        r = _req(P, hits=1, limit=5, duration=P.types.SECOND)
        r.algorithm = 7
        with pytest.raises(ValueError) as e:
            P.oracle.get_rate_limit(P.cache.LRUCache(), r)
        return str(e.value)

    _both(run)


def test_lru_eviction():
    def run(P):
        sec = P.types.SECOND
        cache = P.cache.LRUCache(max_size=3)
        for i in range(4):
            P.oracle.token_bucket(
                cache, _req(P, unique_key=f"k{i}", hits=1, limit=5, duration=sec), now=1_000_000
            )
        assert len(cache) == 3
        rl = P.oracle.token_bucket(
            cache, _req(P, unique_key="k0", hits=1, limit=5, duration=sec), now=1_000_000
        )
        assert rl.remaining == 4
        return [_resp(rl), _cache_state(cache)]

    _both(run)


# -- ExactBackend: decide, decide_chain, snapshot_read ----------------------------


def _stream(P, seed, steps, keys=24):
    """Seeded batches over a small key space: all four algorithms (fixed per
    key, with occasional switches), hits-0 peeks, oversized hits, a few
    GLOBAL-non-owner rows and chained requests, and clock advances."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        n = int(rng.integers(1, 9))
        batch, gnp = [], []
        for _ in range(n):
            k = int(rng.integers(keys))
            algo = k % 4 if rng.random() > 0.05 else int(rng.integers(4))
            chain = []
            if rng.random() < 0.2:
                chain = [
                    P.types.ChainLevel(unique_key=f"parent{int(rng.integers(3))}",
                                       limit=int(rng.choice([3, 8, 40])),
                                       duration=int(rng.choice([0, 5000])))
                    for _ in range(int(rng.integers(1, 3)))
                ]
            batch.append(P.types.RateLimitReq(
                name="exact", unique_key=f"k{k}",
                hits=int(rng.choice([0, 1, 1, 1, 2, 9])),
                limit=int(rng.choice([1, 2, 5, 50])),
                duration=int(rng.choice([400, 2000, 60_000])),
                algorithm=P.types.Algorithm(algo),
                chain=chain,
            ))
            gnp.append(bool(rng.random() < 0.1) and not chain)
        yield batch, gnp, int(rng.choice([0, 0, 1, 7, 150, 900, 2500]))


@pytest.mark.parametrize("seed", [1, 7])
def test_exact_backend_decide_chain_and_snapshot_match(seed):
    def run(P):
        be = P.backends.ExactBackend(64)
        now = T0
        seen = []
        for batch, gnp, dt in _stream(P, seed, 300):
            now += dt
            plain = [(r, g) for r, g in zip(batch, gnp) if not r.chain]
            chained = [r for r in batch if r.chain]
            if plain:
                seen.append([_resp(x) for x in be.decide(
                    [r for r, _ in plain], [g for _, g in plain], now)])
            if chained:
                seen.append([_resp(x) for x in be.decide_chain(chained, now)])
            seen.append(be.snapshot_read(
                [r.hash_key() for r in batch] + ["exact_absent"], now))
        seen.append(_cache_state(be.cache))
        seen.append(be.stats())
        return seen

    _both(run)


def test_exact_backend_update_globals_match():
    def run(P):
        be = P.backends.ExactBackend(16)
        S = P.types.Status
        ups = [
            (f"exact_g{i}", P.types.RateLimitResp(
                status=S.OVER_LIMIT if i % 3 == 0 else S.UNDER_LIMIT,
                limit=10, remaining=i % 4, reset_time=T0 + 1000 * i))
            for i in range(24)
        ]
        be.update_globals(ups)
        reqs = [P.types.RateLimitReq(name="exact", unique_key=f"g{i}", hits=1,
                                     limit=10, duration=60_000)
                for i in range(24)]
        return [
            [_resp(x) for x in be.decide(reqs, [True] * 24, T0 + 5000)],
            be.snapshot_read([k for k, _ in ups], T0 + 5000),
            _cache_state(be.cache),
        ]

    _both(run)


def test_make_backend_exact_holds_no_device_state():
    conf = t_config.ServerConfig(backend="exact", cache_size=123)
    be = t_backends.make_backend(conf)  # no device argument: nothing to place
    assert isinstance(be, t_backends.ExactBackend)
    assert be.cache.max_size == 123
    assert be.inline_decide and not hasattr(be, "engine")
    # multihost with no process group: a one-process mesh, no step pipe
    multi = t_backends.make_backend(
        t_config.ServerConfig(backend="multihost", store_mib=1), device="cpu"
    )
    assert isinstance(multi, t_backends.MultiHostBackend) and multi.engine.pipe is None
    assert multi.engine.n == 1 and not multi.engine.policy.spans_processes
    # mesh, once refused, is the sharded device backend, not the host LRU
    mesh = t_backends.make_backend(
        t_config.ServerConfig(backend="mesh", shards=2, store_mib=1), device="cpu"
    )
    assert isinstance(mesh, t_backends.MeshBackend) and mesh.engine.n == 2
    assert not getattr(mesh, "inline_decide", False)


# -- Instance(ExactBackend) through the batcher's inline path ---------------------


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self) -> int:
        return self.t


def _pin(monkeypatch, clock):
    for mod in (j_types, t_types, j_oracle, t_oracle):
        monkeypatch.setattr(mod, "millisecond_now", clock)


async def _instance(P, clock, **kw):
    conf = P.config.ServerConfig(
        backend="exact", grpc_address=ADDR, advertise_address=ADDR,
        behaviors=P.config.BehaviorConfig(global_sync_wait=600.0), **kw,
    )
    inst = P.instance.Instance(conf, P.backends.ExactBackend(conf.cache_size))
    inst.start()
    await inst.set_peers([P.types.PeerInfo(address=ADDR, is_owner=True)])
    if inst.shed is not None:
        inst.shed.now_fn = clock
    return inst


@pytest.mark.parametrize("seed", [2, 9])
def test_instance_exact_inline_matches(monkeypatch, seed):
    clock = FakeClock()
    _pin(monkeypatch, clock)

    async def main():
        t = await _instance(T, clock, cache_size=64)
        j = await _instance(J, clock, cache_size=64)
        try:
            assert t.batcher._inline and not t.batcher.prep_at_arrival
            calls = []
            orig = t.backend.decide

            def spy(*a, **k):
                calls.append(len(a[0]))
                return orig(*a, **k)

            t.backend.decide = spy
            for (tb, _g, dt), (jb, _h, _d) in zip(_stream(T, seed, 150), _stream(J, seed, 150)):
                clock.t += dt
                a = await t.get_rate_limits(tb)
                b = await j.get_rate_limits(jb)
                assert [_resp(x) for x in a] == [_resp(x) for x in b], (tb, a, b)
            assert calls, "the port's inline decide never ran"
            assert _cache_state(t.backend.cache) == _cache_state(j.backend.cache)
        finally:
            await t.stop()
            await j.stop()

    asyncio.run(main())
