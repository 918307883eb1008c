"""create_share.deep: the groups the decide created or recreated (the
engine's `misses`: no live entry of the key in its bucket) over the
distinct keys of the batches dispatched in the window (`groups`), both
read from the backend's stats."""


def read(run):
    s = run["window"]["stats"]
    groups = s.get("groups")
    return s["misses"] / groups if groups and "misses" in s else None
