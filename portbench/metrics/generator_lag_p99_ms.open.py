"""generator_lag_p99_ms.open: the 99th percentile of (send time - due time)
of the open loop: whether the generator, not the port, set the pace."""

from portbench.load import percentile


def read(run):
    lag = run["window"]["lag_s"]
    return percentile(lag, 99) * 1e3 if lag else None
