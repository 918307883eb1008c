"""promoter_tick_ms.deep: the stage clock's mean `promoter_tick` over the
window: one SketchPromoter.flush_once on the event loop, from its start to
its end, the promotion call it awaits on the submit thread included."""


def read(run):
    s = run["window"]["stages"].get("promoter_tick")
    if not s or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
