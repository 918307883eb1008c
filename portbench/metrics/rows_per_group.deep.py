"""rows_per_group.deep: rows decided over the distinct keys of the batches
dispatched in the window (the engine's `groups` counter, read from the
backend's stats): how many rows of a batch share a key's group."""


def read(run):
    w = run["window"]
    groups = w["stats"].get("groups")
    return w["device_rows"] / groups if groups else None
