"""submit_busy_share.deep: the stage clock's `submit_call` seconds over the
window's seconds: how much of the window the one submit thread spent in
its batches' bodies (prep, merge, dispatch)."""


def read(run):
    s = run["window"]["stages"].get("submit_call")
    if not s or not s["count"]:
        return None
    return s["total_s"] / run["window"]["seconds"]
