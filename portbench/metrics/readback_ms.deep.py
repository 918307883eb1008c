"""readback_ms.deep: the stage clock's mean `readback` per device batch
over the window: inside the engine's dispatch, the pinned output buffer,
the device-to-host copy call and its event."""


def read(run):
    s = run["window"]["stages"].get("readback")
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
