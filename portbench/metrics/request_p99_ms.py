"""request_p99_ms: the 99th percentile over every request of the window,
each timed from its due time in the open-loop schedule to its answer (host
clock); a failed request counts as never answered."""

import math

from portbench.load import percentile


def read(run):
    lat = run["window"]["latency_s"]
    if not lat:
        return None
    v = percentile(lat, 99) * 1e3
    return v if math.isfinite(v) else None
