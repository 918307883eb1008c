"""Server daemon entry point (the port of gubernator_tpu/cli/daemon.py).

`python -m gubernator_tpu_torch.cli.daemon [--config FILE]` — configuration
from GUBER_* env vars with an optional KEY=value config file injected
first (the reference daemon's surface, cmd/gubernator/main.go +
config.go). The node serves on the CUDA device: on a host with no GPU it
exits non-zero with the engine's message, and it has no CPU fallback
(a CPU node is built in code: `Server(conf, device="cpu")`, or
`run_role(conf, device="cpu")`); only GUBER_BACKEND=exact, which holds
no device state, needs no GPU. With GUBER_DIST_COORDINATOR the process
joins a multi-host mesh: process 0 serves over GUBER_BACKEND=multihost,
every other process runs the lockstep follower loop (run_role).
"""

import argparse
import asyncio
import json
import sys

from gubernator_tpu_torch.core.store import DeviceLike
from gubernator_tpu_torch.serve.config import ServerConfig, config_from_env, load_config_file
from gubernator_tpu_torch.serve.logging_setup import setup_logging
from gubernator_tpu_torch.serve.server import run_daemon


def check_dist_config(conf: ServerConfig) -> None:
    """Exit with a diagnostic on the multi-host misconfigurations that
    would otherwise deadlock the whole mesh inside a collective or an
    accept() loop. Touches no process group and no device."""
    if conf.dist_process_id == 0:
        if conf.backend != "multihost":
            raise SystemExit(
                "GUBER_DIST_COORDINATOR is set but GUBER_BACKEND="
                f"{conf.backend!r}; the leader must use "
                "GUBER_BACKEND=multihost"
            )
        if len(conf.dist_followers) != conf.dist_num_processes - 1:
            raise SystemExit(
                f"GUBER_DIST_FOLLOWERS lists "
                f"{len(conf.dist_followers)} addresses but "
                f"GUBER_DIST_NUM_PROCESSES={conf.dist_num_processes} "
                "implies "
                f"{conf.dist_num_processes - 1} followers"
            )
    elif not conf.dist_step_listen:
        raise SystemExit(
            "follower processes (GUBER_DIST_PROCESS_ID > 0) require "
            "GUBER_DIST_STEP_LISTEN"
        )


def run_role(conf: ServerConfig, device: DeviceLike = None) -> int:
    """Run this process's role on `device` (cuda unless the caller asks
    for another). Without GUBER_DIST_COORDINATOR it serves. With it, the
    checks above run first, then the rendezvous; process 0 serves (its
    Server's stop shuts the step pipe), and every other process builds
    the engine from the same config (the ladder, store and sketch
    geometry must equal the leader's: the hello handshake checks them),
    runs the follower loop until the leader shuts the pipe, and prints
    one JSON line of its steps and writeback launches."""
    if not conf.dist_coordinator:
        asyncio.run(run_daemon(conf, device=device))
        return 0
    check_dist_config(conf)
    from gubernator_tpu_torch.core.engine import buckets_for_limit
    from gubernator_tpu_torch.parallel.multihost import (
        MultiHostMeshEngine,
        initialize_distributed,
        shutdown_distributed,
    )
    from gubernator_tpu_torch.parallel.policy import local_devices

    initialize_distributed(conf.dist_coordinator, conf.dist_num_processes, conf.dist_process_id)
    try:
        if conf.dist_process_id == 0:
            asyncio.run(run_daemon(conf, device=device))
            return 0
        eng = MultiHostMeshEngine(
            conf.store_config(),
            buckets=buckets_for_limit(conf.device_batch_limit),
            sketch=conf.sketch_config(),
            devices=local_devices(device),
        )
        eng.follower_loop(conf.dist_step_listen)
        print(json.dumps({"multihost_follower": follower_report(eng)}), flush=True)
        return 0
    finally:
        shutdown_distributed()


def follower_report(eng) -> dict:
    """A follower's count of what it ran: steps by kind, the decides
    among them, its chunks and shards, its writeback launches (on a
    GPU launches = n_local x (decides + install + gossip chunks)), its
    segmented-scan kernel calls, and its captured decide graphs and
    other program graphs."""
    from gubernator_tpu_torch.core.scan import seg_scan
    from gubernator_tpu_torch.core.writeback import writeback_add

    return dict(
        process=eng.policy.process_index, n_local=eng.n_local, steps=dict(eng.steps),
        decides=eng.decides,
        install_chunks=eng.install_chunks, gossip_chunks=eng.gossip_chunks,
        launches=writeback_add.launches, scan_launches=seg_scan.launches,
        graph_count=eng.graph_count,
        program_graph_count=eng.program_graph_count,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="gubernator-tpu daemon on PyTorch/CUDA")
    parser.add_argument(
        "--config",
        default="",
        help="environment config file of KEY=value lines",
    )
    args = parser.parse_args(argv)

    env = None
    if args.config:
        env = load_config_file(args.config)
    conf = config_from_env(env)

    setup_logging(
        level="debug" if conf.debug else conf.log_level,
        json_format=conf.log_json,
    )
    return run_role(conf)


if __name__ == "__main__":
    sys.exit(main())
