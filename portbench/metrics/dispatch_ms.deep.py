"""dispatch_ms.deep: the stage clock's mean `dispatch` per device batch over
the window: epoch bookkeeping, the staging upload and the graph replay call
on the submit thread (the recorder's state copies, a device copy call at
each end of a span, fall inside four of them)."""


def read(run):
    s = run["window"]["stages"].get("dispatch")
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
