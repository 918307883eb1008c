"""CLI load generator (the port of gubernator_tpu/cli/loadgen.py, on the
port's clients).

`python -m gubernator_tpu_torch.cli.loadgen <address>` replays a pool of
random token-bucket limits through a concurrent fan-out forever,
dumping OVER_LIMIT responses (the reference's cmd/gubernator-cli).

r12: `--protocol {grpc,geb,http}` picks the door. r10's profiling
showed the loadgen ITSELF was the ceiling through the gRPC door — its
per-item protobuf encode capped offered load at ~110k dec/s no matter
what the serving side did (the masking problem). The `geb` protocol
speaks credit-windowed binary frames via gubernator_tpu_torch.client_geb
(against a daemon's GUBER_GEB_PORT door or a bridge socket path), and
`http` POSTs binary GEB frames to the gateway's /v1/geb door — both
keep the generator off the critical path and exercise the new client
end to end.

r18: `--protocol shm` drives the bridge's shared-memory lane (requires
a co-located bridge socket path; refuses to fall back so the A/B pair
measures the lane, not a silent downgrade), and `--ring-route 1` turns
on the client's per-owner fast routing against a multi-node ring. The
`--json` summary carries `client` (the client's stats dict: negotiated
transport, downgrades and reason, frames_shm) so perf_gate can assert
the MECHANISM that carried the load, not just the rate.

`--share S` (0..1) switches the workload to the shed-r10 shape: hot
limit-1 keys frozen over limit mixed with never-over keys so a
fraction ~S of items answer OVER_LIMIT (`--share 0` = all cold). The
default workload (no --share) keeps the reference CLI's random pool.
`--json` prints one machine-readable summary line on stdout (implies
--quiet), which scripts/perf_gate.py consumes.

The generator loads no torch (and no jax): it imports only the port's
API types and clients, so a loadgen process takes neither a CUDA context
nor torch's start-up time from the daemons it drives.
"""

import argparse
import asyncio
import json
import sys
import time

from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    ChainLevel,
    RateLimitReq,
    Status,
)
from gubernator_tpu_torch.client import AsyncV1Client, random_string

HOT_KEYS = 512
COLD_KEYS = 4096

#: r15 algorithm suite names (core/algorithms.py registry names, kept
#: as a local literal so the generator stays torch-free)
ALGOS = {
    "token": Algorithm.TOKEN_BUCKET,
    "leaky": Algorithm.LEAKY_BUCKET,
    "sliding": Algorithm.SLIDING_WINDOW,
    "gcra": Algorithm.GCRA,
}


def _chain_levels(depth: int, tenant: int):
    """Ancestor levels for --chain-depth: ONE shared head (the
    consolidation contract routes every chain by chain[0], so one
    hierarchy = one head), generous limits (the gate measures the
    chain lane's dispatch price, not refusals)."""
    if depth <= 0:
        return []
    return [
        ChainLevel("cg:global", 1 << 30, 0),
        ChainLevel(f"cg:region:{tenant % 4}", 1 << 28, 0),
        ChainLevel(f"cg:tenant:{tenant % 64}", 1 << 26, 0),
    ][:depth]


def _shed_pool(
    share: float,
    batch: int,
    keyspace: int = 0,
    algorithm: Algorithm = Algorithm.TOKEN_BUCKET,
    chain_depth: int = 0,
):
    """Pre-built batch rotation in the shed-r10 workload shape: the
    first `share` of each batch hits hot limit-1 keys (over limit
    after their first touch), the rest never-over keys. `keyspace=0`
    keeps the classic 8-batch/4096-cold-id rotation BIT-IDENTICAL to
    the r10-r12 workload (the committed PERF_GATE_BASELINE ratios were
    measured on it). `keyspace>0` (r13) widens the cold pool by
    pre-building enough batches to actually EMIT that many distinct
    cold ids (capped at 256 batches — ~2x a 65k-entry store's capacity
    at 1000-item batches, enough to hold the exact tier at pressure so
    the sketch tier's drop path carries real load)."""
    cut = int(share * batch)
    cold_per_batch = max(1, batch - cut)
    if keyspace > 0:
        n_pools = min(256, -(-keyspace // cold_per_batch))
        cold = keyspace
    else:
        n_pools = 8
        cold = COLD_KEYS
    pools = []
    for i in range(n_pools):
        reqs = []
        for j in range(batch):
            if j < cut:
                key, limit = f"shed_h{(i * 31 + j) % HOT_KEYS}", 1
            else:
                key = f"shed_c{(i * batch + j) % cold}"
                limit = 1_000_000_000
            reqs.append(
                RateLimitReq(
                    name="loadgen",
                    unique_key=key,
                    hits=1,
                    limit=limit,
                    duration=600_000,
                    algorithm=algorithm,
                    behavior=Behavior.BATCHING,
                    chain=_chain_levels(chain_depth, i * batch + j),
                )
            )
        pools.append(reqs)
    return pools


#: per-call bound so a wedged server surfaces as counted errors, never
#: workers hung past the duration (the pre-r12 grpc path used 5s; the
#: binary doors serve deep pipelines, so give them headroom)
CALL_TIMEOUT = 30.0


def _make_client(
    protocol: str,
    address: str,
    window: int,
    mode: str,
    ring_route: bool = False,
):
    if protocol == "grpc":
        return AsyncV1Client(address)
    if protocol in ("geb", "shm"):
        from gubernator_tpu_torch.client_geb import AsyncGebClient

        # `geb` pins the socket transport so the r18 shm_r18 A/B pair
        # measures the lane, not whatever happened to negotiate;
        # `shm` refuses to run without the mapped ring
        return AsyncGebClient(
            address,
            window=window,
            mode=mode,
            timeout=CALL_TIMEOUT,
            shm="require" if protocol == "shm" else "off",
            ring_route=ring_route,
        )
    if protocol == "http":
        from gubernator_tpu_torch.client_geb import AsyncHttpGebClient

        base = (
            address
            if address.startswith("http")
            else f"http://{address}"
        )
        return AsyncHttpGebClient(base, mode=mode, timeout=CALL_TIMEOUT)
    raise ValueError(f"unknown protocol {protocol!r}")


async def run(
    address: str,
    keys: int,
    concurrency: int,
    batch: int,
    duration: float,
    protocol: str = "grpc",
    share: float = -1.0,
    window: int = 0,
    mode: str = "auto",
    quiet: bool = False,
    json_out: bool = False,
    keyspace: int = 0,
    algorithm: str = "token",
    chain_depth: int = 0,
    ring_route: bool = False,
) -> dict:
    client = _make_client(protocol, address, window, mode, ring_route)
    algo = ALGOS[algorithm]
    if share >= 0.0:
        batches = _shed_pool(share, batch, keyspace, algo, chain_depth)
    else:
        pool = [
            RateLimitReq(
                name=f"ID-{i:04d}",
                unique_key=random_string("id-"),
                hits=1,
                limit=(i % 100) + 1,
                duration=((i % 50) + 1) * 1000,
                algorithm=algo,
                behavior=Behavior.BATCHING,
                chain=_chain_levels(chain_depth, i),
            )
            for i in range(keys)
        ]
        batches = None

    stats = {"sent": 0, "over": 0, "errors": 0}
    stop_at = time.monotonic() + duration if duration > 0 else None

    async def worker(wid: int):
        i = wid
        while stop_at is None or time.monotonic() < stop_at:
            if batches is not None:
                reqs = batches[i % len(batches)]
                i += 1
            else:
                reqs = [pool[(i + j) % len(pool)] for j in range(batch)]
                i += batch * concurrency
            try:
                if protocol == "grpc":
                    resps = await client.get_rate_limits(
                        reqs, timeout=CALL_TIMEOUT
                    )
                else:  # geb/http bound via their client-level timeout
                    resps = await client.get_rate_limits(reqs)
            except Exception as e:
                stats["errors"] += 1
                print(f"error: {e}", file=sys.stderr)
                await asyncio.sleep(0.1)
                continue
            stats["sent"] += len(resps)
            for r in resps:
                if r.status == Status.OVER_LIMIT:
                    stats["over"] += 1
                    if not quiet:
                        print(f"over the limit: {r}")

    started = time.monotonic()
    try:
        await asyncio.gather(*(worker(w) for w in range(concurrency)))
    finally:
        elapsed = time.monotonic() - started
        rate = stats["sent"] / elapsed if elapsed > 0 else 0.0
        summary = dict(
            protocol=protocol,
            sent=stats["sent"],
            over_limit=stats["over"],
            errors=stats["errors"],
            seconds=round(elapsed, 4),
            decisions_per_sec=round(rate, 1),
            over_limit_share=round(
                stats["over"] / stats["sent"], 4
            )
            if stats["sent"]
            else 0.0,
        )
        if hasattr(client, "stats"):
            # r18: record what actually negotiated (transport, fast vs
            # string framing, ring routing, downgrade reason) so A/B
            # runs can prove which lane carried the load
            summary["client"] = client.stats()
        print(
            f"sent={stats['sent']} over_limit={stats['over']} "
            f"errors={stats['errors']} rate={rate:.0f}/s",
            file=sys.stderr,
        )
        if json_out:
            print(json.dumps(summary))
        await client.close()
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu load generator")
    parser.add_argument("address", nargs="?", default="127.0.0.1:9090")
    parser.add_argument(
        "--protocol",
        choices=("grpc", "geb", "http", "shm"),
        default="grpc",
        help="front door: gRPC protobuf, binary GEB frames over the "
        "socket (daemon GUBER_GEB_PORT or a bridge socket path; shm "
        "negotiation pinned OFF so A/B pairs stay honest), binary GEB "
        "over HTTP POST /v1/geb, or the r18 shared-memory lane "
        "(requires a co-located bridge unix socket; refuses to fall "
        "back)",
    )
    parser.add_argument("--keys", type=int, default=2000)
    parser.add_argument("--concurrency", type=int, default=10)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument(
        "--duration", type=float, default=0.0, help="seconds; 0 = forever"
    )
    parser.add_argument(
        "--share", type=float, default=-1.0,
        help="shed-r10 workload shape with this over-limit share "
        "(0..1); negative = the default random pool",
    )
    parser.add_argument(
        "--keyspace", type=int, default=0,
        help="widen the --share workload's cold-key pool to this many "
        "distinct ids (0 = the classic 4096); sized past the store's "
        "entry capacity this drives the r13 sketch tier's drop path",
    )
    parser.add_argument(
        "--window", type=int, default=0,
        help="geb protocol: cap the credit window (0 = the server's "
        "advertised window; 1 = round-trip, the pre-r7 shape)",
    )
    parser.add_argument(
        "--mode", choices=("auto", "fast", "string"), default="auto",
        help="geb/http framing: pre-hashed fast records vs string "
        "items (auto negotiates via the hello)",
    )
    parser.add_argument(
        "--ring-route", type=int, choices=(0, 1), default=0,
        help="geb/shm protocols: 1 = shard fast frames per owner "
        "across per-node connections on a multi-node ring (r18 "
        "client-side routing); 0 = the classic single connection",
    )
    parser.add_argument(
        "--algorithm", choices=sorted(ALGOS), default="token",
        help="rate-limit algorithm for every generated request "
        "(r15 suite: token, leaky, sliding, gcra)",
    )
    parser.add_argument(
        "--chain-depth", type=int, default=0,
        help="ancestor quota-chain levels per request (r15; 0 = "
        "plain). Chained items ride string GEBC frames / the proto "
        "chain field; fast framing is bypassed by contract",
    )
    parser.add_argument("--quiet", action="store_true",
                        help="don't print each OVER_LIMIT response")
    parser.add_argument("--json", action="store_true",
                        help="one JSON summary line on stdout "
                        "(implies --quiet)")
    args = parser.parse_args(argv)
    asyncio.run(
        run(
            args.address,
            args.keys,
            args.concurrency,
            args.batch,
            args.duration,
            protocol=args.protocol,
            share=args.share,
            window=args.window,
            mode=args.mode,
            quiet=args.quiet or args.json,
            json_out=args.json,
            keyspace=args.keyspace,
            algorithm=args.algorithm,
            chain_depth=args.chain_depth,
            ring_route=bool(args.ring_route),
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
