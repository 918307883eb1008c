"""The plain reference of one device batch of the serving core: token and
leaky buckets over a set-associative slot store, with an optional
count-min cold tier for the creates the store refuses.

Written from the semantics the port documents (gubernator_tpu_torch
core/kernels.py and core/store.py docstrings: the store layout, the
cumulative-attempt rule for duplicate keys, the writeback plan, the
live-victim rule and the conservative sketch update), in plain Python
and NumPy, one group and one row at a time. It imports nothing of the
program: the hash constants and lane numbers below are frozen copies.

Scope: algorithms 0 (token) and 1 (leaky), no GLOBAL replica reads.
A row of another kind raises `Unsupported`, which the comparison counts
as a failure rather than guessing.

Times are engine milliseconds (int32 envelope); `now` is one batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# -- frozen constants of the store layout --------------------------------------

L_TAG, L_EXPIRE, L_REMAINING, L_TS, L_LIMIT, L_DURATION, L_FLAGS, L_KEYLOW = range(8)
LANES = 8
FLAG_STICKY_OVER = 1
FLAG_ALGO_LEAKY = 2
FLAG_ALGO_SLIDING = 4
FLAG_ALGO_GCRA = 8
FLAG_ALGO_MASK = FLAG_ALGO_LEAKY | FLAG_ALGO_SLIDING | FLAG_ALGO_GCRA
UNDER, OVER = 0, 1
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

_MIX_M1 = 0xBF58476D1CE4E5B9
_MIX_M2 = 0x94D049BB133111EB
_BUCKET_SALT = 0x9E3779B97F4A7C15
SKETCH_SALTS = (0x9AE16A3B2F90404F, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                0x27D4EB2F165667C5)
WINDOW_MIX = 0xD6E8FEB86659FD93


class Unsupported(ValueError):
    """A row or a stored entry outside the reference's scope."""


# -- hashing -------------------------------------------------------------------


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64."""
    x = np.asarray(x, np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX_M1)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX_M2)
    return x ^ (x >> np.uint64(31))


def bucket_index(kh: np.ndarray, buckets: int) -> np.ndarray:
    """int64 bucket of each uint64 key hash."""
    kh = np.asarray(kh, np.uint64)
    return (mix64(kh ^ np.uint64(_BUCKET_SALT)) & np.uint64(buckets - 1)).astype(np.int64)


def fingerprint_u32(kh: np.ndarray) -> np.ndarray:
    """The nonzero 32-bit tag (the hash's high half, 0 -> 1) as uint32 values."""
    fp = (np.asarray(kh, np.uint64) >> np.uint64(32)).astype(np.int64)
    return np.where(fp == 0, 1, fp)


def as_i32(u: np.ndarray) -> np.ndarray:
    """uint32 values (held in int64) as the int32 with the same bits."""
    u = np.asarray(u, np.int64) & 0xFFFFFFFF
    return np.where(u >= 1 << 31, u - (1 << 32), u)


def sketch_indices(kh: np.ndarray, wid: np.ndarray, rows: int, width: int) -> np.ndarray:
    """int64[rows, n] counter index of each (key, fixed-window id)."""
    kh = np.asarray(kh, np.uint64)
    w = np.asarray(wid, np.int64).view(np.uint64)
    base = mix64(kh ^ (w * np.uint64(WINDOW_MIX)))
    out = np.empty((rows, kh.shape[0]), np.int64)
    for r in range(rows):
        out[r] = (mix64(base ^ np.uint64(SKETCH_SALTS[r])) & np.uint64(width - 1)).astype(np.int64)
    return out


def _i32(v: int) -> int:
    """Wrap a Python int into int32, as a device int32 store does."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def victim_key(row: np.ndarray, way: int) -> int:
    """The uint64 key hash an entry was written for: tag high, key-low low."""
    e = row.reshape(-1, LANES)[way]
    return ((int(e[L_TAG]) & 0xFFFFFFFF) << 32) | (int(e[L_KEYLOW]) & 0xFFFFFFFF)


# -- one batch ---------------------------------------------------------------


class Geometry:
    """Store and sketch shapes the configuration states."""

    def __init__(self, buckets: int, ways: int, sketch_rows: int = 0, sketch_width: int = 0):
        self.buckets = int(buckets)
        self.ways = int(ways)
        self.sketch_rows = int(sketch_rows)
        self.sketch_width = int(sketch_width)

    @property
    def two_tier(self) -> bool:
        return self.sketch_rows > 0


def needed_counters(kh: np.ndarray, duration: np.ndarray, now: int, rows_pre: Dict[int, np.ndarray],
                    geo: Geometry) -> np.ndarray:
    """int64[rows, m] every sketch counter a batch can read: each key's at
    its current window, and each touched bucket's eviction victim's."""
    if not geo.two_tier:
        return np.zeros((0, 0), np.int64)
    d = np.maximum(np.asarray(duration, np.int64), 1)
    rows = np.stack(list(rows_pre.values())).reshape(-1, geo.ways, LANES) if rows_pre else \
        np.zeros((0, geo.ways, LANES), np.int32)
    tag = rows[:, :, L_TAG]
    way = np.argmin(np.where(tag == 0, I32_MIN, rows[:, :, L_EXPIRE].astype(np.int64)), axis=1)
    v = rows[np.arange(rows.shape[0]), way]
    v = v[v[:, L_TAG] != 0]
    vk = ((v[:, L_TAG].astype(np.int64) & 0xFFFFFFFF) << 32 | (v[:, L_KEYLOW].astype(np.int64) & 0xFFFFFFFF))
    vw = now // np.maximum(v[:, L_DURATION].astype(np.int64), 1)
    keys = np.concatenate([np.asarray(kh, np.uint64), vk.view(np.uint64)])
    wids = np.concatenate([now // d, vw])
    return sketch_indices(keys, wids, geo.sketch_rows, geo.sketch_width)


def decide_batch(kh, hits, limit, duration, algo, now: int, rows_pre: Dict[int, np.ndarray],
                 counters_pre: Optional[Dict[Tuple[int, int], int]], geo: Geometry):
    """Decide one batch of rows (in arrival order) against the state before
    it. `rows_pre` maps each touched bucket to its int32[ways*8] row;
    `counters_pre` maps (sketch row, index) to its count for every counter
    `needed_counters` names. Returns (answers int64[n, 4] of status,
    limit, remaining, reset in engine ms (0 = none), rows_post,
    counters_post, stats)."""
    kh = np.asarray(kh, np.uint64)
    n = kh.shape[0]
    hits = np.asarray(hits, np.int64)
    limit = np.asarray(limit, np.int64)
    duration = np.asarray(duration, np.int64)
    algo = np.asarray(algo, np.int64)
    if ((algo != 0) & (algo != 1)).any():
        raise Unsupported("the reference decides token (0) and leaky (1) rows only")
    now = int(now)
    ways = geo.ways
    bkt = bucket_index(kh, geo.buckets)
    fpu = fingerprint_u32(kh)
    skey = (bkt.astype(np.uint64) << np.uint64(32)) | fpu.astype(np.uint64)
    order = np.argsort(skey, kind="stable")
    s_sorted = skey[order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    ends = np.r_[starts[1:], n]
    rows_post = {b: r.copy() for b, r in rows_pre.items()}
    counters = dict(counters_pre or {})
    cmax = I32_MAX
    sk_updates = []  # (per-row counter indices, value) scatter-max updates, applied after all reads
    leads = order[starts]
    gidx = (sketch_indices(kh[leads], now // np.maximum(duration[leads], 1), geo.sketch_rows,
                           geo.sketch_width).T.tolist() if geo.two_tier else None)

    def index_of(key: int, wid: int) -> list:
        return sketch_indices(np.array([key], np.uint64), np.array([wid], np.int64),
                              geo.sketch_rows, geo.sketch_width)[:, 0].tolist()

    def est_at(idx: list) -> int:
        return min(counters[(r, i)] for r, i in enumerate(idx))

    # plain Python values from here on: one list of ways a bucket, and
    # each group's leader fields
    rowlist = {b: r.reshape(ways, LANES).tolist() for b, r in rows_pre.items()}
    fp32s = as_i32(fpu[leads]).tolist()
    lead_f = np.stack([leads, bkt[leads], algo[leads], hits[leads], limit[leads], duration[leads]],
                      axis=1).tolist()
    G = []  # group records in sorted (bucket, fingerprint) order
    for gi, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        members = order[s:e]
        lead, b, g_algo, g_hits, g_limQ, g_durQ = lead_f[gi]
        row = rowlist[b]
        fp32 = fp32s[gi]
        fway = next((w for w in range(ways) if row[w][L_TAG] == fp32), -1)
        found = fway >= 0
        fway = max(fway, 0)
        g_exp, g_rem, g_ts, g_limS, g_durS, g_flg = row[fway][L_EXPIRE:L_KEYLOW]
        g_live = found and g_exp >= now
        g_algo = min(max(g_algo, 0), 3)
        if g_live and g_flg & (FLAG_ALGO_SLIDING | FLAG_ALGO_GCRA):
            raise Unsupported("a live sliding-window or GCRA entry")
        stored_algo = 1 if g_flg & FLAG_ALGO_LEAKY else 0
        mismatch = g_live and stored_algo != g_algo
        existing = g_live and not mismatch
        create_algo = 0 if (mismatch and g_algo == 1) else g_algo
        eff_algo = stored_algo if existing else create_algo
        eff_leaky = eff_algo == 1
        leaky_zero = existing and eff_leaky and g_limQ <= 0
        g_durE = g_durS if g_live else g_durQ
        rate = max(g_durE // max(g_limQ, 1), 1)
        leak = max(now - g_ts, 0) // rate
        leaky_R0 = g_rem + min(leak, max(g_limS - g_rem, 0))
        R0_exist = leaky_R0 if eff_leaky else g_rem
        over_c = g_hits > g_limQ
        charged_ldr = (not over_c) and g_hits > 0
        R0_create = g_limQ - (g_hits if charged_ldr else 0)
        if over_c and eff_leaky:
            R0_create = 0
        G.append(dict(
            members=members, lead=lead, b=b, fp32=fp32, found=found, fway=fway,
            g_exp=g_exp, g_rem=g_rem, g_ts=g_ts, g_limS=g_limS, g_durS=g_durS, g_flg=g_flg,
            g_live=g_live, existing=existing, eff_algo=eff_algo, eff_leaky=eff_leaky,
            leaky_zero=leaky_zero, rate=rate, over_c=over_c, charged_ldr=charged_ldr,
            R0=R0_exist if existing else R0_create,
            sticky0=bool(g_flg & FLAG_STICKY_OVER) if existing else (eff_algo == 0 and over_c),
            g_hits=g_hits, g_limQ=g_limQ, g_durQ=g_durQ, sk=False, gi=gi,
            writer=False, way=0, dropped=False, evicted=False,
        ))

    # writeback plan, one bucket at a time (groups sorted by fingerprint)
    by_bucket: Dict[int, list] = {}
    for g in G:
        by_bucket.setdefault(g["b"], []).append(g)
    for b, gs in by_bucket.items():
        row = rowlist[b]
        empties = [w for w in range(ways) if row[w][L_TAG] == 0]
        eway = min(range(ways), key=lambda w: (I32_MIN if row[w][L_TAG] == 0 else row[w][L_EXPIRE], w))
        f_tot = [0] * ways
        for g in gs:
            if not g["leaky_zero"] and g["found"]:
                f_tot[g["fway"]] += 1
        rank = 0
        for g in gs:
            w = not g["leaky_zero"]
            if w and g["found"]:
                g["writer"], g["way"] = True, g["fway"]
            elif w:
                has_empty = rank < len(empties)
                way = empties[rank] if has_empty else eway
                dropped = (not has_empty) and (rank > 0 or f_tot[way] > 0)
                g["dropped"] = dropped
                g["evicted"] = (not has_empty) and not dropped
                g["writer"], g["way"] = not dropped, way
                rank += 1
            if geo.two_tier and g["evicted"]:
                v = row[eway]
                if v[L_TAG] != 0 and v[L_EXPIRE] >= now:  # a live victim: to the sketch
                    g["dropped"], g["evicted"], g["writer"] = True, False, False
                else:  # a dead token victim in its key's window folds its count
                    v_dur = max(v[L_DURATION], 1)
                    v_wid = now // v_dur
                    v_sticky = bool(v[L_FLAGS] & FLAG_STICKY_OVER)
                    consumed = max(v[L_LIMIT] if v_sticky else v[L_LIMIT] - v[L_REMAINING], 0)
                    if (v[L_EXPIRE] > v_wid * v_dur and (v[L_FLAGS] & FLAG_ALGO_MASK) == 0
                            and consumed > 0):
                        vi = index_of(victim_key(rows_pre[b], eway), v_wid)
                        sk_updates.append((vi, est_at(vi) + consumed))
    for g in G:
        if geo.two_tier and g["dropped"]:
            dur_pos = max(g["g_durQ"], 1)
            wid = now // dur_pos
            est = est_at(gidx[g["gi"]])
            est_c = min(min(est, I32_MAX), max(g["g_limQ"], 0))
            g.update(sk=True, sk_est=est, existing=True, eff_leaky=False, eff_algo=0,
                     R0=max(g["g_limQ"] - est_c, 0), sticky0=False, g_exp=(wid + 1) * dur_pos,
                     g_limS=g["g_limQ"], g_durS=g["g_durQ"])

    hits_l, limit_l = hits.tolist(), limit.tolist()
    keylow = as_i32(kh[leads].astype(np.int64) & 0xFFFFFFFF).tolist()
    ans = [None] * n
    st = dict(hits=0, misses=0, dropped=0, evictions=0)
    for g in G:
        st["hits" if g["g_live"] else "misses"] += 1
        st["dropped"] += g["dropped"]
        st["evictions"] += g["evicted"]
        existing, eff_leaky, R0 = g["existing"], g["eff_leaky"], g["R0"]
        S = S_chg = total_charged = 0
        prev_z = any_hits = any_decr = any_z = False
        for p, j in enumerate(g["members"].tolist()):
            h = hits_l[j]
            cl = p == 0 and not existing
            viable = not g["leaky_zero"]
            eligible = viable and 0 < h <= R0
            charged = (eligible and not cl and S <= R0 - h) or (cl and g["charged_ldr"])
            rem_b = max(R0 - S, 0)
            inc_chg = h if (charged and not cl) else 0
            decr = charged and not cl and rem_b - h > 0
            rem_vis = max(R0 - S_chg, 0)
            z = viable and g["eff_algo"] == 0 and R0 - S_chg == 0 and not cl
            sticky_live = g["sticky0"] or (p > 0 and prev_z)
            if rem_vis == 0:
                status, rem = OVER, 0
            elif charged or h == 0:
                status, rem = (OVER if sticky_live else UNDER), (rem_vis - h if charged else rem_vis)
            else:
                status, rem = OVER, rem_vis
            reset = g["g_exp"] if existing else now + g["g_durQ"]
            if eff_leaky:
                lk_over = rem_vis == 0 or (not charged and h != 0)
                status = OVER if lk_over else UNDER
                reset = now + g["rate"] if lk_over else 0
            lim = g["g_limS"] if existing else g["g_limQ"]
            if cl:
                status = OVER if g["over_c"] else UNDER
                rem = (0 if eff_leaky else g["g_limQ"]) if g["over_c"] else g["g_limQ"] - g["g_hits"]
                reset = 0 if eff_leaky else now + g["g_durQ"]
            if g["leaky_zero"]:
                status, rem, reset, lim = OVER, 0, now + g["g_durS"], limit_l[j]
            ans[j] = (status, _i32(lim), _i32(rem), _i32(reset))
            S += h if (eligible and not cl) else 0
            S_chg += inc_chg
            total_charged += inc_chg
            any_hits |= viable and h != 0
            any_decr |= decr
            any_z |= z
            prev_z = z
        if g["sk"]:
            sk_updates.append((gidx[g["gi"]], g["sk_est"] + total_charged))
        if not g["writer"]:
            continue
        ldr_chg = g["g_hits"] if (not existing and g["charged_ldr"]) else 0
        rem_final = R0 + ldr_chg - (total_charged + ldr_chg)
        sticky_final = g["sticky0"] or any_z
        if eff_leaky:
            new_exp = (now + g["g_durS"] if any_decr else g["g_exp"]) if existing else now + g["g_durQ"]
        else:
            new_exp = g["g_exp"] if existing else now + g["g_durQ"]
        new_ts = g["g_ts"] if (existing and eff_leaky and not any_hits) else now
        flags = (FLAG_ALGO_LEAKY if eff_leaky else 0) | (
            FLAG_STICKY_OVER if g["eff_algo"] == 0 and sticky_final else 0)
        vals = [g["fp32"], new_exp, rem_final, new_ts,
                g["g_limS"] if existing else g["g_limQ"],
                g["g_durS"] if existing else g["g_durQ"], flags, keylow[g["gi"]]]
        rows_post[g["b"]].reshape(ways, LANES)[g["way"]] = [_i32(v) for v in vals]

    for idx, value in sk_updates:
        v = min(value, cmax)
        for r, i in enumerate(idx):
            counters[(r, i)] = max(counters[(r, i)], v)
    return np.array(ans, np.int64).reshape(n, 4), rows_post, counters, st


# -- the promoter's install ----------------------------------------------------


def promote(kh, limit, duration, now: int, rows_pre: Dict[int, np.ndarray],
            counters: Dict[Tuple[int, int], int], geo: Geometry):
    """The sketch promoter's migration of hot keys into the exact tier, as
    the port documents it (TorchEngine.promote_from_sketch and
    core/kernels.py upsert_globals): each key's count-min estimate of its
    current fixed window; the keys without a live exact entry get a token
    window with remaining = max(limit - estimate, 0), reset at the
    window's end, sticky when the estimate reached the limit. Placement
    is the decide's writeback plan: a key whose tag is in its bucket
    overwrites that way, the others take the bucket's empty ways in
    fingerprint order and then the eviction way, which only the first
    such key of a bucket may take; of duplicate keys the last wins.
    `counters` maps (sketch row, index) to its count for each key's
    current-window indices. Returns ((installed, estimate, reset, over),
    rows_post), reset in engine ms."""
    kh = np.asarray(kh, np.uint64)
    limit = np.asarray(limit, np.int64)
    d = np.maximum(np.asarray(duration, np.int64), 1)
    n = kh.shape[0]
    wid = now // d
    idx = sketch_indices(kh, wid, geo.sketch_rows, geo.sketch_width).T.tolist()
    est = np.array([min(counters[(r, i)] for r, i in enumerate(ix)) for ix in idx], np.int64)
    reset = (wid + 1) * d
    over = est >= limit
    remaining = np.maximum(limit - est, 0)
    bkt = bucket_index(kh, geo.buckets).tolist()
    fp32 = as_i32(fingerprint_u32(kh)).tolist()
    keylow = as_i32(kh.astype(np.int64) & 0xFFFFFFFF).tolist()
    ways = geo.ways
    rowlist = {b: r.reshape(ways, LANES).tolist() for b, r in rows_pre.items()}
    installed = np.zeros(n, bool)
    last = {}
    for j in range(n):
        row = rowlist[bkt[j]]
        live = any(row[w][L_TAG] == fp32[j] and row[w][L_EXPIRE] >= now for w in range(ways))
        installed[j] = not live
        if not live:
            last[(bkt[j], fingerprint_u32(kh[j:j + 1])[0])] = j
    rows_post = {b: r.copy() for b, r in rows_pre.items()}
    by_bucket: Dict[int, list] = {}
    for (b, fpu), j in sorted(last.items()):
        by_bucket.setdefault(b, []).append(j)
    for b, js in by_bucket.items():
        row = rowlist[b]
        empties = [w for w in range(ways) if row[w][L_TAG] == 0]
        eway = min(range(ways), key=lambda w: (I32_MIN if row[w][L_TAG] == 0 else row[w][L_EXPIRE], w))
        fway = {j: next((w for w in range(ways) if row[w][L_TAG] == fp32[j]), -1) for j in js}
        f_tot = [0] * ways
        for j in js:
            if fway[j] >= 0:
                f_tot[fway[j]] += 1
        rank = 0
        for j in js:
            if fway[j] >= 0:
                way = fway[j]
            else:
                has_empty = rank < len(empties)
                way = empties[rank] if has_empty else eway
                rank += 1
                if not has_empty and (rank > 1 or f_tot[way] > 0):
                    continue  # dropped
            vals = [fp32[j], _i32(min(reset[j], I32_MAX)), _i32(min(remaining[j], I32_MAX)), 0,
                    _i32(min(limit[j], I32_MAX)), 0, FLAG_STICKY_OVER if over[j] else 0, keylow[j]]
            rows_post[b].reshape(ways, LANES)[way] = vals
    return (installed, est, reset, over), rows_post
