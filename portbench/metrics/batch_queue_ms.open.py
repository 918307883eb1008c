"""batch_queue_ms.open: the stage clock's mean `batch_queue` per group over the
window: a group's wait from enqueue to the flusher's collect."""


def read(run):
    s = run["window"]["stages"].get("batch_queue")
    return s["mean_ms"] if s and s["count"] else None
