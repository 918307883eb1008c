"""sketch_served_share.deep: creates served from the sketch (`dropped` in the
engine's stats) over the rows the device decided in the window."""


def read(run):
    w = run["window"]
    if not run["geo"].two_tier or not w["device_rows"]:
        return None
    return w["stats"]["dropped"] / w["device_rows"]
