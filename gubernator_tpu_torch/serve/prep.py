"""Host-prep pipeline: sorted-run merge combine (the port's copy of
gubernator_tpu/serve/prep.py).

With arrival-time prep (serve/batcher.py), each caller group is
converted, clipped and PRE-SORTED on a small prep pool when it is
enqueued, so by flush time a batch is a set of sorted runs and the only
serialized host work left is stitching them together. This module is
that stitch: a stable k-way merge of pre-sorted uint64 key runs, O(n log
k) instead of the O(n log n) full sort, built from `np.searchsorted`
passes. The merge equals `np.argsort(concat, kind="stable")` over the
concatenated unsorted batch (equal keys keep run order, runs arrive in
caller order), which is what makes the merged device fields
byte-identical to the flush-time presort path. `merge_runs` dispatches
to the fused native merge (guber_merge_runs in native/guberhash.cc, one
pass without the GIL) when the library loads; the numpy merge here is
its byte-identical twin. Imports no torch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.native import load_hashlib

#: field order of a prepped run's `fields` dict (backends._ArrayOps.ARRAY_FIELDS)
RUN_FIELDS = ("key_hash", "hits", "limit", "duration", "algo", "gnp")


def _native():
    """native/hashlib_native when the library loads, else None."""
    return load_hashlib()


def _merge2(
    a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable two-way merge of (sorted_keys, payload) pairs: equal keys
    from `a` land before equal keys from `b` (searchsorted sides left/
    right), matching a stable sort of their concatenation."""
    sa, ta = a
    sb, tb = b
    na, nb = sa.shape[0], sb.shape[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    pos_a = np.searchsorted(sb, sa, side="left") + np.arange(
        na, dtype=np.int64
    )
    pos_b = np.searchsorted(sa, sb, side="right") + np.arange(
        nb, dtype=np.int64
    )
    s = np.empty(na + nb, sa.dtype)
    t = np.empty(na + nb, ta.dtype)
    s[pos_a] = sa
    s[pos_b] = sb
    t[pos_a] = ta
    t[pos_b] = tb
    return s, t


def merge_sorted_runs(
    skeys: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable k-way merge of pre-sorted key runs.

    Returns `(skey, take)` where `skey` is the merged sorted stream and
    `take[i]` indexes the VIRTUAL concatenation of the runs:
    `skey == np.concatenate(skeys)[take]`. Because each run is
    stable-sorted and ties across runs resolve in run order, `take` is
    exactly `np.argsort(np.concatenate(skeys_unsorted), kind="stable")`
    composed with the per-run sorts — the property the merge-combine
    equivalence contract rests on."""
    offsets = np.zeros(len(skeys) + 1, np.int64)
    np.cumsum([s.shape[0] for s in skeys], out=offsets[1:])
    nodes = [
        (np.asarray(s, np.uint64),
         np.arange(offsets[i], offsets[i + 1], dtype=np.int64))
        for i, s in enumerate(skeys)
    ]
    if not nodes:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    # pairwise tree merge in run order: log2(k) levels, each one linear
    # pass + two binary-search gathers; adjacent pairing preserves run
    # order, which _merge2's left/right sides turn into tie stability
    while len(nodes) > 1:
        nxt = [
            _merge2(nodes[i], nodes[i + 1])
            if i + 1 < len(nodes)
            else nodes[i]
            for i in range(0, len(nodes), 2)
        ]
        nodes = nxt
    return nodes[0]


def merge_runs(runs: List[dict]) -> Dict[str, np.ndarray]:
    """Merge per-group prepped runs (engine `prep_run` output) into one
    batch-level sorted field set for `decide_submit_presorted`.

    Each run carries `n`, sorted `skey`, within-group `order` (caller
    index of sorted row j), per-shard `counts`, and device-dtype
    `fields` in sorted order. The merged `order` maps each merged row
    to its index in the FLATTENED batch (groups concatenated in caller
    order) — the permutation `decide_wait` unpermutes responses with.
    """
    if len(runs) == 1:
        r = runs[0]
        return dict(
            skey=r["skey"],
            order=np.asarray(r["order"], np.int32),
            counts=r["counts"],
            fields=r["fields"],
        )
    counts = runs[0]["counts"].copy()
    for r in runs[1:]:
        counts += r["counts"]
    hn = _native()
    if hn is not None:
        n = int(sum(r["n"] for r in runs))
        m = hn.merge_runs_native(runs, n)  # flat (B == n)
        return dict(
            skey=m["skey"],
            order=m["order"],
            counts=counts,
            fields={k: m[k] for k in RUN_FIELDS},
        )
    skey, take = merge_sorted_runs([r["skey"] for r in runs])
    base = 0
    gorders = []
    for r in runs:
        gorders.append(np.asarray(r["order"], np.int64) + base)
        base += r["n"]
    order = np.concatenate(gorders)[take].astype(np.int32)
    fields = {
        k: np.concatenate([r["fields"][k] for r in runs])[take]
        for k in RUN_FIELDS
    }
    return dict(skey=skey, order=order, counts=counts, fields=fields)
