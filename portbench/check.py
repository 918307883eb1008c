"""The comparison that decides `correct`: the port against the plain
reference (portbench/reference/), after the window has closed and the
program has been freed.

1. The start: the state the prefill left (sampled bucket rows and sketch
   counters), against the reference's prefill from scratch; a cell with no
   prefill starts from an empty store.
2. The spans: runs of consecutive device batches of the window, pipelined
   as every batch is, with any promoter installs among them
   (harness.Recorder). Each event's rows and readable counters were
   gathered just before it, so the first gather of each is its state at
   the span's open. The reference replays each span from those, in the
   order the port's submit thread issued it, with the harness's own
   groups; every answer those groups got is compared (as a multiset per
   key, since the rows of one key in one batch are interchangeable), so
   are the promoter's results, and so is every word of the touched rows
   and counters at the close. The rest of the state is held by digests
   (portbench/devread.py): a row or chunk no event touched must keep its
   digest, and a touched one must change it by exactly what its gathered
   words changed, which also shows that its first gather was its state at
   the open. `state_words_differing` counts the touched words that differ
   and every other word of a row or chunk whose digest is off.
3. Every answer of the window, range-checked, and every request answered.

Each number is compared with a limit; `correct` is every number within it.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.devread import CHUNK, term_np
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


def distinct(a) -> np.ndarray:
    """The sorted distinct values of `a`, by a sort: NumPy 2.3's hashed
    `np.unique` took 1.7 s for 2M int64 on the card's host (PERF.md)."""
    a = np.sort(np.asarray(a).ravel())
    return a[np.r_[True, a[1:] != a[:-1]]] if a.shape[0] else a


SPAN_KEYS = ("batches", "rows", "batch_rows_differing", "answers_differing", "state_words_differing",
             "unsupported", "sketch_groups", "installs", "install_results_differing")


def _key_order(kh: np.ndarray, ans: np.ndarray, buckets: int) -> np.ndarray:
    """Rows sorted by (bucket, fingerprint, status, limit, remaining, reset)."""
    bk = bucket_index(kh, buckets)
    fp = fingerprint_u32(kh)
    return np.lexsort((ans[:, 3], ans[:, 2], ans[:, 1], ans[:, 0], fp, bk))


class Counters:
    """The sketch counters a span gathered: sorted flat indices (row r at
    r * width) and their values, replayed in place. Reading one the span
    never gathered raises KeyError."""

    def __init__(self, flat: np.ndarray, val: np.ndarray, width: int):
        self.flat, self.val, self.width = flat, val, width

    def _pos(self, flat: np.ndarray) -> np.ndarray:
        pos = np.minimum(np.searchsorted(self.flat, flat), max(self.flat.shape[0] - 1, 0))
        if flat.shape[0] and (self.flat.shape[0] == 0 or (self.flat[pos] != flat).any()):
            raise KeyError("a counter the span did not gather")
        return pos

    def read(self, idx: np.ndarray) -> dict:
        """(sketch row, index) -> count at per-row indices `idx`."""
        rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
        pos = self._pos(idx.ravel() + rows * self.width)
        return dict(zip(zip(rows.tolist(), idx.ravel().tolist()), self.val[pos].tolist()))

    def write(self, counts: dict) -> None:
        if counts:
            ri = np.array(list(counts), np.int64)
            self.val[self._pos(ri[:, 0] * self.width + ri[:, 1])] = list(counts.values())


def _write_back(store: dict, sketch, rows_post: dict, cnt_post) -> None:
    for b, r in rows_post.items():
        store[b] = r
    if cnt_post:
        sketch.write(cnt_post)


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
    bk = distinct(bucket_index(kh, geo.buckets))
    rows_pre = {int(b): store[b] for b in bk}
    counters = None
    if geo.two_tier:
        counters = sketch.read(needed_counters(kh, cat["duration"], e_now, rows_pre, geo))
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
    bk = distinct(bucket_index(kh, geo.buckets))
    rows_pre = {int(b): store[b] for b in bk}
    (inst, est, reset, over), rows_post = promote(kh, ev["limit"], ev["duration"], e_now, rows_pre,
                                                   sketch.read(idx), geo)
    _write_back(store, sketch, rows_post, None)
    g_inst, g_est, g_reset, g_over = ev["result"]
    want = np.stack([inst.astype(np.int64), est, reset, over.astype(np.int64)])
    got = np.stack([g_inst, g_est, np.where(g_reset == 0, 0, g_reset - epoch), g_over])
    out["installs"] += int(inst.sum())
    out["install_results_differing"] += int(np.count_nonzero((want != got).any(axis=0)))


def _start(sp: dict, geo):
    """The state at the span's open of what it touched: bucket -> row and
    the gathered counters, each from its first gather; with the sorted
    buckets and flat counter indices, and where each first was."""
    bk = np.concatenate([ev["bk"] for ev in sp["events"]]) if sp["events"] else np.zeros(0, np.int64)
    ub, first = np.unique(bk, return_index=True)
    store = dict(zip(ub.tolist(), sp["rows0"][first]))
    cu, cfirst = np.unique(sp["ctr_idx"], return_index=True)
    sketch = Counters(cu, sp["ctr0"][cfirst].astype(np.int64), geo.sketch_width) if geo.two_tier else None
    return store, sketch, ub, first, cu, cfirst


def _state_words_differing(sp: dict, store: dict, sketch, ub, first, cu, cfirst, geo) -> int:
    """Touched words at the close that differ from the reference's, plus
    every other word of a row or chunk whose digest says it moved unseen."""
    width = sp["rows0"].shape[1]
    if not np.array_equal(ub, sp["union"]):
        raise KeyError("the buckets gathered at the close are not those the events touched")
    rows1 = sp["rows1"]
    ref = np.stack([store[b] for b in ub.tolist()]) if ub.shape[0] else rows1
    diff = int(np.count_nonzero(ref != rows1))
    with np.errstate(over="ignore"):
        moved = sp["d_rows0"][first].view(np.uint64) - sp["d_rows1"].view(np.uint64)
    diff += width * int(np.count_nonzero(moved != sp["row_delta"].view(np.uint64)))
    diff += width * int(sp["untouched"][0])
    if sketch is None:
        return diff
    c0 = sp["ctr0"][cfirst].astype(np.int64)
    c1 = sp["ctr1"][cfirst].astype(np.int64)
    diff += int(np.count_nonzero(sketch.val != c1))
    lanes = cu % CHUNK
    with np.errstate(over="ignore"):
        moved = term_np(c0, lanes, sp["salts"]) - term_np(c1, lanes, sp["salts"])
    chunk, at, held = np.unique(cu // CHUNK, return_index=True, return_counts=True)
    per_chunk = np.zeros(chunk.shape[0], np.uint64)
    np.add.at(per_chunk, np.searchsorted(chunk, cu // CHUNK), moved)
    off = per_chunk != sp["chunk_delta"][cfirst][at].view(np.uint64)
    diff += int((CHUNK - held[off]).sum())
    return diff + CHUNK * int(sp["untouched"][1])


def check_span(sp: dict, answers: dict, geo) -> dict:
    """Differences between the port and the reference over one span."""
    out = dict.fromkeys(SPAN_KEYS, 0)
    if not sp["opened"]:
        return out
    if sp["broken"]:
        out["unsupported"] = sum(sum(g["key_hash"].shape[0] for g in ev["groups"] if g is not None)
                                 for ev in sp["events"] if ev["kind"] == "batch") or 1
        return out
    try:
        store, sketch, ub, first, cu, cfirst = _start(sp, geo)
        for ev in sp["events"]:
            if ev["kind"] == "batch":
                _replay_batch(ev, sp["epoch"], answers, store, sketch, geo, out)
            else:
                _replay_promote(ev, sp["epoch"], store, sketch, geo, out)
        out["state_words_differing"] = _state_words_differing(sp, store, sketch, ub, first, cu, cfirst, geo)
    except (Unsupported, KeyError):
        out["unsupported"] += max(out["rows"], 1)
    return out


def check_start(start: dict, cfg: dict, geo) -> int:
    """Words of the sampled start state that differ from the reference's."""
    if not start["ids"]:
        return int(start["store_nonzero"])
    a = cfg["assumed"]
    nows = np.asarray(start["nows"], np.int64) - int(start["epoch"])
    rows, sketch, collisions = prefill_state(
        lambda lo, hi: hash_ids(np.arange(lo, hi)), int(start["ids"]), start["batch_rows"], nows,
        int(a["limit"]), int(a["duration_ms"]), geo, start["buckets"])
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
    t0 = time.monotonic()
    per = [check_span(sp, run["answers"], geo) for sp in run["spans"]]
    t1 = time.monotonic()
    start_diff = check_start(run["start"], run["config"], geo)
    run["compare_s"] = dict(spans=t1 - t0, start=time.monotonic() - t1)
    tot = {k: sum(p[k] for p in per) for k in SPAN_KEYS}
    c = run["check"]
    opened = sum(1 for sp in run["spans"] if sp["opened"] and sp["at"] == "batch")
    checks = {
        "start_words_differing": (start_diff, 0, "at_most"),
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
