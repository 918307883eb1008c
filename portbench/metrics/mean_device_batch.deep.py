"""mean_device_batch.deep: rows over device batches in the window, from
the batcher's device_batch_size histogram (serve/metrics.py)."""


def read(run):
    w = run["window"]
    return w["device_rows"] / w["device_batches"] if w["device_batches"] else None
