"""launch_ms.deep: the stage clock's mean `launch` per device batch over
the window: inside the engine's dispatch, the staging pack, the upload and
the graph replay call (the eager programs where there is no graph)."""


def read(run):
    s = run["window"]["stages"].get("launch")
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
