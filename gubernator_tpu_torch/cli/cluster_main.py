"""Standalone local test cluster (the port of
gubernator_tpu/cli/cluster_main.py).

`python -m gubernator_tpu_torch.cli.cluster_main` boots a 6-node cluster
on 127.0.0.1:9090-9095, each node on the CUDA device, and prints "Ready"
(the reference's cmd/gubernator-cluster, used by client e2e test
fixtures).
"""

import sys
import time

from gubernator_tpu_torch.cluster import LocalCluster


def main(argv=None) -> int:
    addresses = [f"127.0.0.1:{p}" for p in range(9090, 9096)]
    cluster = LocalCluster(addresses)
    cluster.start()
    print("Ready", flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
