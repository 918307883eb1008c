"""merge_ms.deep: the stage clock's mean `merge` per device batch over the
window (serve/stages.py STAGES, reset at the window's start): the submit
thread's k-way merge of the groups' sorted runs."""


def read(run):
    s = run["window"]["stages"].get("merge")
    return s["mean_ms"] if s and s["count"] else None
