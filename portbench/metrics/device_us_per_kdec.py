"""device_us_per_kdec: the card's time in the port's captured programs
(CUDA events on the replaying stream around every replay submitted in the
window: the decides, the installs, the promoter's top-k) per 1,000 rows of
the batches submitted in the window."""


def read(run):
    w = run["window"]
    if not w.get("replays") or not w.get("replay_rows"):
        return None
    return w["replay_s"] * 1e6 / (w["replay_rows"] / 1e3)
