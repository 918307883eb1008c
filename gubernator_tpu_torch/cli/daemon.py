"""Server daemon entry point (the port of gubernator_tpu/cli/daemon.py).

`python -m gubernator_tpu_torch.cli.daemon [--config FILE]` — configuration
from GUBER_* env vars with an optional KEY=value config file injected
first (the reference daemon's surface, cmd/gubernator/main.go +
config.go). The node serves on the CUDA device: on a host with no GPU it
exits non-zero with the engine's message, and it has no CPU fallback
(a CPU node is built in code: `Server(conf, device="cpu")`). The
multi-host mesh (GUBER_DIST_COORDINATOR) is not ported and is refused.
"""

import argparse
import asyncio
import sys

from gubernator_tpu_torch.serve.config import config_from_env, load_config_file
from gubernator_tpu_torch.serve.logging_setup import setup_logging
from gubernator_tpu_torch.serve.server import run_daemon


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
    asyncio.run(run_daemon(conf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
