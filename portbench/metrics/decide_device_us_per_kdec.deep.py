"""decide_device_us_per_kdec.deep: device busy time (the union of the
device's intervals in torch.profiler) over the traced slice, per 1,000
decisions answered in it."""


def read(run):
    p = run.get("profile")
    if not p or not p["events"] or not p["rows"]:
        return None
    return p["busy_ns"] / 1e3 / (p["rows"] / 1e3)
