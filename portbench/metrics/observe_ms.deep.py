"""observe_ms.deep: the stage clock's mean `observe` per device batch over
the window: the promoter's hot-key observer called from the engine's
dispatch on the submit thread, the wait for the top-k table's lock
included (two-tier cells; the exact tier has no observer)."""


def read(run):
    s = run["window"]["stages"].get("observe")
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
