"""The comparison that decides `correct`: the port against the plain
reference (portbench/reference/), after the window has closed and the
program has been freed.

1. The start: the state the prefill left (sampled bucket rows and sketch
   counters), against the reference's prefill from scratch; a cell with no
   prefill starts from an empty store.
2. The spans: runs of consecutive device batches of the window, pipelined
   as every batch is, with any promoter installs among them, each between
   two copies of the whole store and sketch (harness.Recorder). The
   reference replays each span from its first copy, in the order the
   port's submit thread issued it, with the harness's own groups; every
   answer those groups got is compared (as a multiset per key, since the
   rows of one key in one batch are interchangeable), so are the
   promoter's results, and so is every word of the second copy.
3. Every answer of the window, range-checked, and every request answered.

Each number is compared with a limit; `correct` is every number within it.
"""

from __future__ import annotations

import numpy as np

from portbench.keyhash import hash_ids
from portbench.reference.limiter import (
    Unsupported,
    bucket_index,
    decide_batch,
    fingerprint_u32,
    needed_counters,
    promote,
    sketch_indices,
)
from portbench.reference.prefill import prefill_state

SPAN_KEYS = ("batches", "rows", "batch_rows_differing", "answers_differing", "state_words_differing",
             "unsupported", "sketch_groups", "installs", "install_results_differing")


def _key_order(kh: np.ndarray, ans: np.ndarray, buckets: int) -> np.ndarray:
    """Rows sorted by (bucket, fingerprint, status, limit, remaining, reset)."""
    bk = bucket_index(kh, buckets)
    fp = fingerprint_u32(kh)
    return np.lexsort((ans[:, 3], ans[:, 2], ans[:, 1], ans[:, 0], fp, bk))


def _counters(sketch: np.ndarray, idx: np.ndarray) -> dict:
    return {(r, int(i)): int(sketch[r, i]) for r in range(idx.shape[0]) for i in idx[r]}


def _write_back(store, sketch, rows_post: dict, cnt_post) -> None:
    for b, r in rows_post.items():
        store[b] = r
    for (r, i), v in (cnt_post or {}).items():
        sketch[r, i] = v


def _replay_batch(ev: dict, epoch: int, answers: dict, store, sketch, geo, out: dict) -> None:
    """One batch of a span: the reference decides it from `store` and
    `sketch` (updated in place), and its answers are compared."""
    groups = ev["groups"]
    cat = {k: np.concatenate([g[k] for g in groups])
           for k in ("key_hash", "hits", "limit", "duration", "algo")}
    kh = np.asarray(cat["key_hash"], np.uint64)
    n = kh.shape[0]
    e_now = ev["now"] - epoch
    out["batches"] += 1
    out["rows"] += n
    if ev["merged_n"] != n or not np.array_equal(ev["merged_kh"], np.sort(kh)):
        out["batch_rows_differing"] += abs(ev["merged_n"] - n) or n
    bk = np.unique(bucket_index(kh, geo.buckets))
    rows_pre = {int(b): store[b] for b in bk}
    counters = None
    if geo.two_tier:
        counters = _counters(sketch, needed_counters(kh, cat["duration"], e_now, rows_pre, geo))
    ref, rows_post, cnt_post, st = decide_batch(
        kh, cat["hits"], cat["limit"], cat["duration"], cat["algo"], e_now, rows_pre, counters, geo)
    _write_back(store, sketch, rows_post, cnt_post if geo.two_tier else None)
    out["sketch_groups"] += st["dropped"] if geo.two_tier else 0
    got = []
    for g in groups:
        a = answers.get(id(g))
        if a is None:  # never answered: every row differs
            a = np.full((4, g["key_hash"].shape[0]), -1, np.int64)
        got.append(a.T)
    got = np.concatenate(got).copy()
    got[:, 3] = np.where(got[:, 3] == 0, 0, got[:, 3] - epoch)
    a_ref = ref[_key_order(kh, ref, geo.buckets)]
    a_got = got[_key_order(kh, got, geo.buckets)]
    out["answers_differing"] += int(np.count_nonzero((a_ref != a_got).any(axis=1)))


def _replay_promote(ev: dict, epoch: int, store, sketch, geo, out: dict) -> None:
    """One promoter install call of a span, replayed and compared."""
    kh = ev["key_hash"]
    e_now = ev["now"] - epoch
    d = np.maximum(ev["duration"], 1)
    idx = sketch_indices(kh, e_now // d, geo.sketch_rows, geo.sketch_width)
    bk = np.unique(bucket_index(kh, geo.buckets))
    rows_pre = {int(b): store[b] for b in bk}
    (inst, est, reset, over), rows_post = promote(kh, ev["limit"], ev["duration"], e_now, rows_pre,
                                                   _counters(sketch, idx), geo)
    _write_back(store, sketch, rows_post, None)
    g_inst, g_est, g_reset, g_over = ev["result"]
    want = np.stack([inst.astype(np.int64), est, reset, over.astype(np.int64)])
    got = np.stack([g_inst, g_est, np.where(g_reset == 0, 0, g_reset - epoch), g_over])
    out["installs"] += int(inst.sum())
    out["install_results_differing"] += int(np.count_nonzero((want != got).any(axis=0)))


def check_span(sp: dict, answers: dict, geo) -> dict:
    """Differences between the port and the reference over one span."""
    out = dict.fromkeys(SPAN_KEYS, 0)
    if not sp["opened"]:
        return out
    if sp["broken"]:
        out["unsupported"] = sum(sum(g["key_hash"].shape[0] for g in ev["groups"] if g is not None)
                                 for ev in sp["events"] if ev["kind"] == "batch") or 1
        return out
    store = sp["store0"].copy()
    sketch = sp["sketch0"].astype(np.int64) if sp["sketch0"] is not None else None
    try:
        for ev in sp["events"]:
            if ev["kind"] == "batch":
                _replay_batch(ev, sp["epoch"], answers, store, sketch, geo, out)
            else:
                _replay_promote(ev, sp["epoch"], store, sketch, geo, out)
    except (Unsupported, KeyError):
        out["unsupported"] += max(out["rows"], 1)
        return out
    out["state_words_differing"] = int(np.count_nonzero(store != sp["store1"]))
    if sketch is not None:
        out["state_words_differing"] += int(np.count_nonzero(sketch != sp["sketch1"]))
    return out


def check_start(start: dict, cfg: dict, geo) -> int:
    """Words of the sampled start state that differ from the reference's."""
    if not start["ids"]:
        return int(start["store_nonzero"])
    a = cfg["assumed"]
    kh = hash_ids(np.arange(start["ids"]))
    nows = np.asarray(start["nows"], np.int64) - int(start["epoch"])
    rows, sketch, collisions = prefill_state(
        kh, start["batch_rows"], nows, int(a["limit"]), int(a["duration_ms"]), geo, start["buckets"])
    keep = ~np.isin(start["buckets"], collisions)
    diff = int(np.count_nonzero(rows[keep] != start["rows"][keep])) + int(start.get("refused", 0))
    if sketch is not None:
        idx = start["counter_idx"]
        want = np.stack([sketch[r, idx[r]] for r in range(idx.shape[0])])
        diff += int(np.count_nonzero(want != start["counters"]))
    return diff


def compare(run: dict) -> tuple:
    """(correct, checks): each check is {"value", "limit", "must"}, where
    `must` says whether the value has to be at most or at least the limit."""
    geo = run["geo"]
    per = [check_span(sp, run["answers"], geo) for sp in run["spans"]]
    tot = {k: sum(p[k] for p in per) for k in SPAN_KEYS}
    c = run["check"]
    opened = sum(1 for sp in run["spans"] if sp["opened"] and sp["at"] == "batch")
    checks = {
        "start_words_differing": (check_start(run["start"], run["config"], geo), 0, "at_most"),
        "spans_checked": (opened, sum(1 for sp in c["spans"] if sp.get("at", "batch") == "batch"),
                          "at_least"),
        "batches_checked": (tot["batches"], int(c["min_batches"]), "at_least"),
        "answers_checked": (tot["rows"], int(c["min_rows"]), "at_least"),
        "sketch_groups_checked": (tot["sketch_groups"], int(c.get("min_sketch_groups", 0)), "at_least"),
        "installs_checked": (tot["installs"], 0, "at_least"),
        "batch_rows_differing": (tot["batch_rows_differing"], 0, "at_most"),
        "answers_differing": (tot["answers_differing"], 0, "at_most"),
        "install_results_differing": (tot["install_results_differing"], 0, "at_most"),
        "state_words_differing": (tot["state_words_differing"], 0, "at_most"),
        "rows_unsupported": (tot["unsupported"], 0, "at_most"),
        "answers_out_of_range": (run["totals"]["out_of_range"], 0, "at_most"),
        "requests_failed": (run["totals"]["failed"], 0, "at_most"),
    }
    ok = all(v <= lim if must == "at_most" else v >= lim for v, lim, must in checks.values())
    return ok, {k: dict(value=v, limit=lim, must=m) for k, (v, lim, m) in checks.items()}
