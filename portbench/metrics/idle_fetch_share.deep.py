"""idle_fetch_share.deep: of the traced slice's idle device nanoseconds,
the share the port's batch timeline puts in the `fetch` category
(portbench/timeline.py). Read only where the traced slice armed the
timeline (portbench/timeline_run.py); None elsewhere."""


def read(run):
    p = run.get("profile")
    if not p or "idle_by" not in p or not p["idle_ns"]:
        return None
    return p["idle_by"]["fetch"] / p["idle_ns"]
