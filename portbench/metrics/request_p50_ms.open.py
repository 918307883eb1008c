"""request_p50_ms.open: the median of the same per-request times as
request_p99_ms (load generator, client view)."""

import math

from portbench.load import percentile


def read(run):
    lat = run["window"]["latency_s"]
    if not lat:
        return None
    v = percentile(lat, 50) * 1e3
    return v if math.isfinite(v) else None
