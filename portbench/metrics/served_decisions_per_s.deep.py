"""served_decisions_per_s.deep: every row of every group answered inside
the window, counted by the callers, over the window's seconds (host
clock). The serving core is host-paced, so this rate follows the host's
speed; it is reported per layer, beside the steady device time per
decision that stands end to end."""


def read(run):
    w = run["window"]
    if run["traffic"]["loop"] != "closed":
        return None
    return w["rows_in_window"] / w["seconds"]
