"""device_idle_share.open: 1 - (the union of the device's intervals over the
traced slice's wall time), from torch.profiler."""


def read(run):
    p = run.get("profile")
    return p["idle_share"] if p and p["events"] else None
