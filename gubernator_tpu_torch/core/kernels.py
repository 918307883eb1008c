"""The batched rate-limit decide (PyTorch port of
gubernator_tpu.core.kernels): the exact tier and the two-tier store.

One branch-free pass evaluates a whole presorted batch of requests
against the slot store: every reference branch is a mask, the per-key
LRU lookup is one gather of whole bucket rows, and the state write is
one add of delta rows (core.writeback, a hand-written CUDA kernel on the
card). Semantics, caller contract and the cumulative-attempt rule for
duplicate keys are the JAX package's, documented at
gubernator_tpu/core/kernels.py:1-85 and :563-599; this module reproduces
its results byte for byte (tests/test_torch_decide.py,
tests/test_torch_sketch.py).

With a `Sketch` (decide_presorted_sketch), creates the exact tier
refuses (way exhaustion, or a live eviction victim) are decided from the
count-min cold tier instead, dead token victims' consumed counts fold
into it, and the tier takes a conservative update: per row, a
scatter-max of estimate + charged, saturating at the counter dtype's max
(gubernator_tpu/core/kernels.py:532-560, :841-1011, :1147-1179). The
sketch tensor is updated in place like the store. `decide` and
`upsert_globals` sort on the device (stable argsort on the unsigned
order of core.store.group_sort_key) and reuse the same writeback.

PyTorch idiom: plain functions on tensors, eager. The store tensor is
updated IN PLACE (JAX donates it), and every tensor of one call lives on
the store's device. What differs from jnp and is handled here:

- key hashes are int64 bit patterns (core.store explains why);
- `lax.associative_scan` has no eager counterpart: the segmented
  saturating scan, the segment starts, the reverse min-scan of the
  segment ends and jnp.cumsum along a row are core.scan's (a hand-written
  CUDA kernel on the card; on the CPU an int64 cumsum minus the
  segment's exclusive start, clamped at 2^31-1, a cummax, flip + cummin
  + flip, and an int64 cumsum cast back to int32);
- first-index ties of jnp.argmax/argmin are computed explicitly
  (`_first_true`), so they hold on every device;
- torch indexing raises on out-of-range indices where jnp.take clips, so
  the JAX code's explicit clips (lead_clip) are kept;
- uint64 casts of window ids and key halves are int64 sign extension
  and masks; the uint64 multiplies wrap identically in int64.

With a `chain_id` (decide_presorted_chain), rows are coupled into quota
chains: a chain any of whose rows is refused has every other row's charge
rolled back before the one writeback (no partial debit,
gubernator_tpu/core/kernels.py:495-529, :1275-1335). The chain program is
exact-only and never touches the sketch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gubernator_tpu_torch.core import scan
from gubernator_tpu_torch.core.algorithms import SLIDING_MAX_DURATION_MS
from gubernator_tpu_torch.core.sketches import (
    SKETCH_SALTS_I64,
    WINDOW_MIX_I64,
    Sketch,
)
from gubernator_tpu_torch.core.store import (
    FLAG_ALGO_GCRA,
    FLAG_ALGO_LEAKY,
    FLAG_ALGO_MASK,
    FLAG_ALGO_SLIDING,
    FLAG_STICKY_OVER,
    L_DURATION,
    L_EXPIRE,
    L_FLAGS,
    L_KEYLOW,
    L_LIMIT,
    L_REMAINING,
    L_TAG,
    L_TS,
    LANES,
    Store,
    bucket_index,
    decode_sort_key,
    fingerprints,
    group_sort_key,
    low32,
    mix64,
    unsigned_order,
)
from gubernator_tpu_torch.core.writeback import writeback_add

UNDER = 0
OVER = 1

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1

_i32 = torch.int32
_i64 = torch.int64


class BatchRequest(NamedTuple):
    """Request batch; all tensors are [B] on one device."""

    key_hash: torch.Tensor  # int64 bit patterns of uint64 hashes
    hits: torch.Tensor  # int32 (host-saturated)
    limit: torch.Tensor  # int32
    duration: torch.Tensor  # int32 (engine-clamped ms)
    algo: torch.Tensor  # int32: 0 token, 1 leaky, 2 sliding, 3 GCRA
    gnp: torch.Tensor  # bool: GLOBAL non-owner replica read
    valid: torch.Tensor  # bool: padding mask


class BatchGroups(NamedTuple):
    """Group (unique-key) structure of a presorted batch, padded to a
    [G] rung (gubernator_tpu/core/kernels.py:140 documents the padding
    conventions): key_hash [G], leader_pos [G], end_pos [G], valid [G],
    group_id [B]."""

    key_hash: torch.Tensor
    leader_pos: torch.Tensor
    end_pos: torch.Tensor
    valid: torch.Tensor
    group_id: torch.Tensor


class BatchResponse(NamedTuple):
    """Responses; all tensors are int32 [B]."""

    status: torch.Tensor
    limit: torch.Tensor
    remaining: torch.Tensor
    reset_time: torch.Tensor  # engine-ms (0 = no reset, leaky UNDER)


class BatchStats(NamedTuple):
    hits: torch.Tensor  # int32 scalar: groups answered from live state
    misses: torch.Tensor  # int32 scalar: groups created/recreated
    dropped: torch.Tensor  # int32 scalar: creates lost to way exhaustion
    evictions: torch.Tensor  # int32 scalar: live entries overwritten


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip: minimum(maximum(x, lo), hi), bounds scalar or tensor."""
    x = torch.clamp_min(x, lo) if not torch.is_tensor(lo) else torch.maximum(x, lo)
    return torch.clamp_max(x, hi) if not torch.is_tensor(hi) else torch.minimum(x, hi)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along axis 1, 0 where none (jnp.argmax of
    a bool matrix), int32."""
    n = mask.shape[1]
    ids = torch.arange(n, dtype=_i32, device=mask.device)
    first = torch.where(mask, ids, n).amin(dim=1)
    return torch.where(first == n, 0, first).to(_i32)


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """jnp.argmin along axis 1 with ties to the first index, int32."""
    return _first_true(x == x.amin(dim=1, keepdim=True))


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted right by one along axis 0, with `fill` at position 0."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-1]])


# The request rows' segmented prefix sums (core/scan.py), by the JAX
# package's name: they alone go through `_seg_scan`, so that
# portbench/control.py's `dedup` control can replace just them.
_seg_scan = scan.seg_scan


def _sketch_lookup(sketch: Sketch, kh: torch.Tensor, wid: torch.Tensor):
    """Per-group (min-estimate int64[G], per-row index list int32[G]) for
    window-keyed key hashes (int64 bit patterns). `wid` may be int32: it
    is sign-extended to int64 as jnp's cast to uint64 does, and the
    window-mix multiply wraps like uint64. MUST stay bit-identical to
    core.sketches.sketch_indices_np (test-pinned)."""
    rows, width = sketch.data.shape
    base = mix64(kh ^ (wid.to(_i64) * WINDOW_MIX_I64))
    idxs = [
        (mix64(base ^ SKETCH_SALTS_I64[r]) & (width - 1)).to(_i32)
        for r in range(rows)
    ]
    return sketch_min(sketch.data, idxs).to(_i64), idxs


def sketch_min(data: torch.Tensor, idxs) -> torch.Tensor:
    """Min over rows r of data[r, idxs[r]]: the count-min estimate at
    per-row counter indices (a list of [n] tensors or one [rows, n])."""
    est = None
    for r, idx in enumerate(idxs):
        c = data[r].index_select(0, idx)
        est = c if est is None else torch.minimum(est, c)
    return est


def _writeback_plan(
    cand: torch.Tensor,  # int32[G, ways, LANES] pre-write bucket contents
    bkt: torch.Tensor,  # int32[G] bucket per item, sorted non-decreasing
    write_item: torch.Tensor,  # bool[G] the group designated to write
    found: torch.Tensor,  # bool[G] tag matched in the bucket
    fway: torch.Tensor,  # int32[G] matching way (valid where found)
    eway: torch.Tensor,  # int32[G] eviction-candidate way (for misses)
    is_b_leader: torch.Tensor,  # bool[G] first item of its bucket segment
    b_end: torch.Tensor,  # int32[G] inclusive end of the bucket segment
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """WHO writes WHERE, and which creates drop (way exhaustion) or
    evict a live occupant: (writer, way, dropped, evicted), all [G].
    Way-disjointness of the writes is what lets the writeback add delta
    rows without a merge (gubernator_tpu/core/kernels.py:419-470)."""
    ways = cand.shape[1]
    way_ids = torch.arange(ways, dtype=_i32, device=cand.device)[None, :]
    miss_w = write_item & ~found
    found_w = write_item & found
    onehotF = (found_w[:, None] & (fway[:, None] == way_ids)).to(_i32)

    # bucket-segment prefix/total machinery over [G, 1+ways] in ONE
    # segmented scan: col 0 ranks miss-writers, cols 1.. count
    # found-writers/way (counts <= G: the saturation never engages)
    stacked = torch.cat([miss_w.to(_i32)[:, None], onehotF], dim=1)
    incl = scan.seg_scan(is_b_leader, stacked)
    prefix = incl - stacked  # strictly-before-j within my bucket
    totals = incl[b_end.long()]

    rank = prefix[:, 0]  # earlier miss-writers in my bucket
    empty = cand[:, :, L_TAG] == 0
    cumempty = scan.row_cumsum(empty.to(_i32))
    n_empty = cumempty[:, -1]
    # the (rank)-th empty way (0-indexed) of my bucket
    pick = empty & (cumempty == (rank + 1)[:, None])
    has_empty = rank < n_empty
    eway_sel = torch.where(has_empty, _first_true(pick), eway)
    # eviction fallback: conflict if any found-group WRITES my victim way
    f_tot = totals[:, 1:]
    fconf = torch.where(eway_sel[:, None] == way_ids, f_tot, 0).sum(dim=1) > 0
    dropped = miss_w & ~has_empty & ((rank > 0) | fconf)
    evicted = miss_w & ~has_empty & ~dropped

    writer = found_w | (miss_w & ~dropped)
    way = torch.where(found, fway, eway_sel)
    return writer, way, dropped, evicted


def _writeback_apply(
    data: torch.Tensor,  # int32[buckets, ways*LANES], updated in place
    bkt: torch.Tensor,  # int32[G] sorted bucket per item
    writer: torch.Tensor,  # bool[G] from _writeback_plan
    way: torch.Tensor,  # int32[G] from _writeback_plan
    new_vals: torch.Tensor,  # int32[G, LANES] the update for writer rows
    cand: torch.Tensor,  # int32[G, ways, LANES] pre-write bucket contents
) -> torch.Tensor:
    """Apply the planned updates as ONE add of delta rows: each writer
    adds (new - old) into its way's lanes of its bucket row (int32 wrap
    self-corrects on the add); every other row adds zeros. On CUDA the
    add is always the csrc/writeback.cu kernel."""
    G, ways, _ = cand.shape
    ar = torch.arange(G, device=cand.device)
    old8 = cand[ar, way.long()]  # old entry lanes at the destination way
    delta8 = torch.where(writer[:, None], new_vals - old8, 0)
    drow = torch.zeros_like(cand)
    drow[ar, way.long()] = delta8
    return writeback_add(data, bkt, drow.view(G, ways * LANES))


def _writeback_delta_add(
    data: torch.Tensor,  # int32[buckets, ways*LANES], updated in place
    bkt: torch.Tensor,  # int32[B] sorted bucket per item, in range
    write_item: torch.Tensor,  # bool[B] at most one writer per group
    found: torch.Tensor,  # bool[B] tag matched in the bucket
    fway: torch.Tensor,  # int32[B] matching way (valid where found)
    eway: torch.Tensor,  # int32[B] eviction-candidate way
    new_vals: torch.Tensor,  # int32[B, LANES] the update for writer rows
    cand: torch.Tensor,  # int32[B, ways, LANES] pre-write bucket contents
    is_b_leader: torch.Tensor,  # bool[B] first item of its bucket segment
    b_end: torch.Tensor,  # int32[B] inclusive end of the bucket segment
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """_writeback_plan + _writeback_apply in one call: (data, n_dropped,
    n_evicted). The way-disjointness argument that lets the delta rows
    add without a merge is gubernator_tpu/core/kernels.py:436-470."""
    writer, way, dropped, evicted = _writeback_plan(
        cand, bkt, write_item, found, fway, eway, is_b_leader, b_end
    )
    return (
        _writeback_apply(data, bkt, writer, way, new_vals, cand),
        dropped.sum().to(_i32),
        evicted.sum().to(_i32),
    )


def decide_presorted(
    store: Store,
    req: BatchRequest,
    now,
    groups: Optional[BatchGroups] = None,
) -> Tuple[Store, BatchResponse, BatchStats]:
    """Exact-only decide of one PRESORTED padded batch; updates
    `store.data` in place and returns (store, responses, stats).
    Responses come back in the (sorted) row order. `now` is int32
    engine-ms: a 0-d int32 tensor on the store's device (what a captured
    graph reads, core/graphs.py) or an int. See _decide_presorted for
    the caller contract."""
    store, _sketch, resp, stats = _decide_presorted(store, req, now, groups, None)
    return store, resp, stats


def decide_presorted_chain(
    store: Store,
    req: BatchRequest,
    now,
    chain_id: torch.Tensor,
    groups: Optional[BatchGroups] = None,
) -> Tuple[Store, BatchResponse, BatchStats]:
    """Quota-chain decide of one PRESORTED padded batch whose rows are
    coupled into chains: `chain_id` int32[B] gives each row its chain
    slot in [0, B) (a chained request's levels share one; every other
    row has its own). Each row decides as decide_presorted would, then a
    chain with ANY refused row has every other member's charge rolled
    back before the single writeback: a refusal at one level consumes
    quota at no other. Responses stay the per-row verdicts (the serving
    tier collapses them, most restrictive wins). Exact-only: the sketch
    is neither read nor written. With every chain a singleton the
    results and the store bytes equal decide_presorted's. Mirrors
    gubernator_tpu/core/kernels.py:495."""
    store, _sketch, resp, stats = _decide_presorted(
        store, req, now, groups, None, chain_id=chain_id
    )
    return store, resp, stats


def decide_presorted_sketch(
    store: Store,
    sketch: Sketch,
    req: BatchRequest,
    now,
    groups: Optional[BatchGroups] = None,
) -> Tuple[Store, Sketch, BatchResponse, BatchStats]:
    """Two-tier decide: the exact slot store stays the heavy-hitter tier
    with byte-identical semantics, and creates it refuses are decided
    from the count-min cold tier (fail-closed: estimates never
    under-count what they were charged). Updates `store.data` and
    `sketch.data` in place; `stats.dropped` counts the sketch-served
    groups. Mirrors gubernator_tpu/core/kernels.py:532."""
    return _decide_presorted(store, req, now, groups, sketch)


def _decide_presorted(
    store: Store,
    req: BatchRequest,
    now,
    groups: Optional[BatchGroups],
    sketch,
    chain_id=None,
):
    """Evaluate one PRESORTED padded batch. Caller contract
    (engine.pad_request_sorted): rows are ordered so that (bucket,
    fingerprint) of the key hash is non-decreasing over the WHOLE batch,
    padding rows repeat the last real key with valid=False; `groups`
    (optional) is the host-computed group structure padded to a [G]
    rung, else it is derived here at G == B. Mirrors
    gubernator_tpu/core/kernels.py:563; `sketch` is None (exact only) or
    the cold tier's Sketch, `chain_id` None or the chain slots of
    decide_presorted_chain (never both); `now` a 0-d int32 tensor on
    the store's device or an int (decide_presorted)."""
    data = store.data
    dev = data.device
    buckets, _W = data.shape
    ways = _W // LANES
    B = req.key_hash.shape[0]
    # `now` is read on the device, so a captured graph replays with the
    # value its static input holds; an int becomes that 0-d int32 here.
    # A 0-d tensor never promotes a dimensioned one, so every `now + x`
    # keeps the type the reference's int gives it.
    if not torch.is_tensor(now):
        now = torch.full((), int(now), dtype=_i32, device=dev)
    now64 = now.to(_i64)

    h = req.hits
    lim_q = req.limit
    algo = req.algo
    gnp = req.gnp
    valid = req.valid
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    true1 = torch.ones(1, dtype=torch.bool, device=dev)

    if groups is None:
        # On-device grouping at G == B: group slot g sits at the group's
        # leader position; follower positions become padding slots.
        ar = torch.arange(B, dtype=_i32, device=dev)
        bkt_r = bucket_index(req.key_hash, buckets)
        fp_r = fingerprints(req.key_hash)
        same_prev = torch.cat(
            [false1, (bkt_r[1:] == bkt_r[:-1]) & (fp_r[1:] == fp_r[:-1])]
        )
        is_leader = ~same_prev
        groups = BatchGroups(
            key_hash=req.key_hash,
            leader_pos=ar,
            end_pos=scan.segment_ends(is_leader),
            valid=is_leader & valid,
            group_id=scan.leader_pos(is_leader),
        )
    else:
        gi = groups.group_id
        same_prev = torch.cat([false1, gi[1:] == gi[:-1]])
        is_leader = ~same_prev

    G = groups.leader_pos.shape[0]
    lead_clip = torch.clamp_max(groups.leader_pos, B - 1).long()
    end_pos_G = groups.end_pos.long()
    group_id = groups.group_id.long()

    # ---- group-level state: gathers and lookup at [G] ---------------------
    kh_G = groups.key_hash
    bkt = bucket_index(kh_G, buckets)  # [G] non-decreasing
    fp = fingerprints(kh_G)

    # ONE sorted gather of whole bucket rows, one row per GROUP
    cand = data.index_select(0, bkt).view(G, ways, LANES)

    match = cand[:, :, L_TAG] == fp[:, None]  # [G, ways]
    found = match.any(dim=1)
    fway = _first_true(match)  # first matching way

    # eviction candidate among the ways: empty first, else earliest expiry
    evict_key = torch.where(cand[:, :, L_TAG] == 0, _I32_MIN, cand[:, :, L_EXPIRE])
    eway = _argmin_first(evict_key)

    sel = cand[torch.arange(G, device=dev), fway.long()]  # found-way state
    g_exp = sel[:, L_EXPIRE]
    g_rem = sel[:, L_REMAINING]
    g_ts = sel[:, L_TS]
    g_limS = sel[:, L_LIMIT]
    g_durS = sel[:, L_DURATION]
    g_flg = sel[:, L_FLAGS]

    g_live = found & (g_exp >= now)  # lazy expiry

    # the leader's request fields define the group's semantics
    lead_req = torch.stack([algo, h, lim_q, req.duration], dim=-1)[lead_clip]
    g_algo = torch.clamp(lead_req[:, 0], 0, 3)
    g_hits = lead_req[:, 1]
    g_limQ = lead_req[:, 2]
    g_durQ = lead_req[:, 3]

    stored_leaky = (g_flg & FLAG_ALGO_LEAKY) != 0
    stored_sld = (g_flg & FLAG_ALGO_SLIDING) != 0
    stored_gcra = (g_flg & FLAG_ALGO_GCRA) != 0
    stored_algo = (
        stored_leaky.to(_i32) * 1 + stored_sld.to(_i32) * 2 + stored_gcra.to(_i32) * 3
    )
    req_leaky = g_algo == 1
    # algorithm switch recreates the window (token/leaky pair as a fresh
    # token bucket both ways; sliding/GCRA as their own algorithm)
    mismatch = g_live & (stored_algo != g_algo)
    existing = g_live & ~mismatch
    create_algo = torch.where(mismatch & req_leaky, 0, g_algo)
    eff_algo = torch.where(existing, stored_algo, create_algo)
    eff_leaky = eff_algo == 1
    eff_sld = eff_algo == 2
    eff_gcra = eff_algo == 3

    # leaky guard: existing leaky group with request limit <= 0
    leaky_zero = existing & eff_leaky & (g_limQ <= 0)

    g_durE = torch.where(g_live, g_durS, g_durQ)
    rate = torch.clamp_min(g_durE // torch.clamp_min(g_limQ, 1), 1)
    leak = torch.clamp_min(now - g_ts, 0) // rate
    leaky_R0 = g_rem + torch.minimum(leak, torch.clamp_min(g_limS - g_rem, 0))

    # sliding window: rotate the stored subwindow pair to `now` (int64)
    d_sld = torch.clamp(g_durS.to(_i64), 1, SLIDING_MAX_DURATION_MS)
    sld_ws0 = g_exp.to(_i64) - 2 * d_sld
    sld_k = torch.clamp_min((now64 - sld_ws0) // d_sld, 0)
    sld_ws = sld_ws0 + sld_k * d_sld  # current subwindow start
    sld_cur0 = torch.where(sld_k == 0, g_rem, 0)
    sld_prev0 = torch.where(sld_k == 0, g_ts, torch.where(sld_k == 1, g_rem, 0))
    sld_wrem = d_sld - (now64 - sld_ws)  # in (0, d]
    sld_used = sld_cur0.to(_i64) + (sld_prev0.to(_i64) * sld_wrem) // d_sld
    lim_s64 = g_limS.to(_i64)
    lim_s64_pos = torch.clamp_min(lim_s64, 0)
    R0_sld = _clip(lim_s64 - sld_used, 0, lim_s64_pos).to(_i32)

    # GCRA: the stored L_EXPIRE lane IS the theoretical arrival time
    T_stored = torch.clamp_min(g_durS.to(_i64) // torch.clamp_min(lim_s64, 1), 1)
    tau_stored = torch.clamp_max(T_stored * lim_s64_pos, _I32_MAX)
    tat0_stored = torch.clamp_min(g_exp.to(_i64), now64)
    R0_gcra = _clip(
        (now64 + tau_stored - tat0_stored) // T_stored, 0, lim_s64_pos
    ).to(_i32)

    # group budget at batch start
    R0_exist = torch.where(eff_leaky, leaky_R0, g_rem)
    R0_exist = torch.where(eff_sld, R0_sld, R0_exist)
    R0_exist = torch.where(eff_gcra, R0_gcra, R0_exist)

    # creation by the group leader
    over_c = g_hits > g_limQ
    charged_ldr = ~over_c & (g_hits > 0)
    R0_create = g_limQ - torch.where(charged_ldr, g_hits, 0)
    R0_create = torch.where(over_c & eff_leaky, 0, R0_create)

    R0 = torch.where(existing, R0_exist, R0_create)
    sticky0 = torch.where(
        existing, (g_flg & FLAG_STICKY_OVER) != 0, (eff_algo == 0) & over_c
    )

    # effective GCRA params per group (stored for existing, request's
    # for creations)
    eff_lim64 = torch.where(existing, lim_s64, g_limQ.to(_i64))
    eff_dur64 = torch.where(existing, g_durS.to(_i64), g_durQ.to(_i64))
    gcra_T = torch.clamp_min(eff_dur64 // torch.clamp_min(eff_lim64, 1), 1)
    gcra_tau = torch.clamp_max(gcra_T * torch.clamp_min(eff_lim64, 0), _I32_MAX)
    gcra_tat0 = torch.where(existing, tat0_stored, now64)
    # sliding response reset: the current subwindow's end (existing) or
    # the creation window's end
    sld_reset_G = torch.where(
        existing & eff_sld,
        _clip(sld_ws + d_sld, _I32_MIN, _I32_MAX),
        (now + g_durQ).to(_i64),
    ).to(_i32)

    # ---- writeback plan (before the responses, as in the JAX kernel) ------
    w_mask = groups.valid & ~leaky_zero
    is_b_leader_G = torch.cat([true1, bkt[1:] != bkt[:-1]])
    b_end_G = scan.segment_ends(is_b_leader_G)
    writer_G, way_G, dropped_G, evicted_G = _writeback_plan(
        cand, bkt, w_mask, found, fway, eway, is_b_leader_G, b_end_G
    )

    existing0 = existing  # before the sketch override below
    if sketch is not None:
        # live-victim protection: a create whose eviction victim is still
        # LIVE goes to the sketch instead of wiping the victim's window
        v_sel = cand[torch.arange(G, device=dev), eway.long()]
        victim_live = (v_sel[:, L_TAG] != 0) & (v_sel[:, L_EXPIRE] >= now)
        sk_extra = evicted_G & victim_live
        dropped_G = dropped_G | sk_extra
        evicted_G = evicted_G & ~sk_extra

        # eviction -> sketch fold: a recycled DEAD token victim whose
        # window overlaps its key's current fixed window folds its
        # consumed count (its whole limit if sticky-over) into the sketch
        # at (victim key, current window); the key hash is rebuilt from
        # L_TAG (high 32 bits) | L_KEYLOW (low 32 bits)
        v_dur_pos = torch.clamp_min(v_sel[:, L_DURATION], 1)
        v_wid = now // v_dur_pos
        v_overlap = v_sel[:, L_EXPIRE] > v_wid * v_dur_pos
        v_token = (v_sel[:, L_FLAGS] & FLAG_ALGO_MASK) == 0
        v_sticky = (v_sel[:, L_FLAGS] & FLAG_STICKY_OVER) != 0
        v_consumed = torch.clamp_min(
            torch.where(
                v_sticky, v_sel[:, L_LIMIT], v_sel[:, L_LIMIT] - v_sel[:, L_REMAINING]
            ),
            0,
        )
        fold_G = evicted_G & v_overlap & v_token & (v_consumed > 0)
        v_kh = ((v_sel[:, L_TAG].to(_i64) & 0xFFFFFFFF) << 32) | (
            v_sel[:, L_KEYLOW].to(_i64) & 0xFFFFFFFF
        )
        v_est, v_idx = _sketch_lookup(sketch, v_kh, v_wid)
        v_upd = torch.where(fold_G, v_est + v_consumed.to(_i64), 0)
        writer_G = writer_G & ~sk_extra

        # sketch-served groups: token/leaky on fixed-window token math
        # over the current window's estimate; sliding on the window-ring
        # blend of the current and previous windows; GCRA on a TAT
        # re-quantized from the same two estimates (host twins:
        # core.algorithms.sketch_sliding_budget / sketch_gcra_budget)
        sk_g = dropped_G
        sk_tok = sk_g & (eff_algo <= 1)
        sk_sld = sk_g & (eff_algo == 2)
        sk_gcra = sk_g & (eff_algo == 3)
        dur_pos = torch.clamp_min(g_durQ, 1)
        wid = now // dur_pos  # int32: engine now >= 0
        window_end = (wid + 1) * dur_pos
        sk_est, sk_idx = _sketch_lookup(sketch, kh_G, wid)
        sk_prev, _ = _sketch_lookup(sketch, kh_G, wid - 1)  # -1 at window 0
        est32 = torch.clamp_max(sk_est, _I32_MAX).to(_i32)
        lim_pos = torch.clamp_min(g_limQ, 0)
        est_c = torch.minimum(est32, lim_pos)
        lim64 = lim_pos.to(_i64)
        cur_c = torch.minimum(sk_est, lim64)
        prev_c = torch.minimum(sk_prev, lim64)
        d64 = dur_pos.to(_i64)
        wend64 = window_end.to(_i64)
        sld_used_sk = cur_c + (prev_c * (wend64 - now64)) // d64
        R0_sk_sld = _clip(g_limQ.to(_i64) - sld_used_sk, 0, lim64).to(_i32)
        ws64 = wend64 - d64  # current epoch window start
        tatq = torch.clamp_min(ws64 - d64 + gcra_tau + gcra_T, now64) + (
            cur_c + prev_c
        ) * gcra_T
        # floor division: now + tau - tatq is negative once the TAT runs
        # past the burst tolerance
        R0_sk_gcra = _clip(
            torch.div(now64 + gcra_tau - tatq, gcra_T, rounding_mode="floor"),
            0,
            lim64,
        ).to(_i32)
        # sketch groups ride the "existing window" machinery; token/leaky
        # collapse to algo 0, sliding/GCRA keep theirs with the ring budget
        existing = existing | sk_g
        eff_leaky = eff_leaky & ~sk_g
        eff_algo = torch.where(sk_tok, 0, eff_algo)
        R0 = torch.where(sk_g, torch.clamp_min(g_limQ - est_c, 0), R0)
        R0 = torch.where(sk_sld, R0_sk_sld, R0)
        R0 = torch.where(sk_gcra, R0_sk_gcra, R0)
        sticky0 = sticky0 & ~sk_g
        g_exp = torch.where(sk_g, window_end, g_exp)  # token reset
        sld_reset_G = torch.where(sk_sld, window_end, sld_reset_G)
        gcra_tat0 = torch.where(sk_gcra, torch.clamp_max(tatq, _I32_MAX), gcra_tat0)
        g_limS = torch.where(sk_g, g_limQ, g_limS)  # params echo the
        g_durS = torch.where(sk_g, g_durQ, g_durS)  # request's

    # ---- bridge: group values needed per request, one stacked gather ------
    bridge = torch.stack(
        [
            existing.to(_i32),
            eff_leaky.to(_i32),
            R0,
            sticky0.to(_i32),
            rate,
            g_exp,
            g_rem,
            g_limS,
            g_durS,
            g_limQ,
            g_durQ,
            over_c.to(_i32),
            leaky_zero.to(_i32),
            # existing0: a sketch-served group is not a token replica
            (existing0 & (stored_algo == 0)).to(_i32),
            charged_ldr.to(_i32),
            g_hits,
            eff_algo,
            sld_reset_G,
            gcra_T.to(_i32),  # T <= duration: fits int32
            gcra_tau.to(_i32),  # clamped to I32_MAX above
            gcra_tat0.to(_i32),  # <= I32_MAX by envelope
        ],
        dim=-1,
    )[group_id]
    existing_r = bridge[:, 0] != 0
    eff_leaky_r = bridge[:, 1] != 0
    R0_r = bridge[:, 2]
    sticky0_r = bridge[:, 3] != 0
    rate_r = bridge[:, 4]
    g_exp_r = bridge[:, 5]
    g_rem_r = bridge[:, 6]
    g_limS_r = bridge[:, 7]
    g_durS_r = bridge[:, 8]
    g_limQ_r = bridge[:, 9]
    g_durQ_r = bridge[:, 10]
    over_c_r = bridge[:, 11] != 0
    leaky_zero_r = bridge[:, 12] != 0
    tok_replica_r = bridge[:, 13] != 0  # existing & stored token
    charged_ldr_r = bridge[:, 14] != 0
    g_hits_r = bridge[:, 15]
    eff_algo_r = bridge[:, 16]
    eff_sld_r = eff_algo_r == 2
    eff_gcra_r = eff_algo_r == 3
    sld_reset_r = bridge[:, 17]
    gcra_T_r = bridge[:, 18].to(_i64)
    gcra_tau_r = bridge[:, 19].to(_i64)
    gcra_tat0_r = bridge[:, 20].to(_i64)

    # GLOBAL non-owner replica read: answer from the live entry, no
    # mutation; on a miss the request is processed as if owned
    gnp_served = gnp & tok_replica_r

    is_creation_leader = is_leader & ~existing_r

    # ---- cumulative-attempt prefix within groups --------------------------
    viable = valid & ~gnp_served & ~leaky_zero_r
    eligible = viable & (h > 0) & (h <= R0_r)
    inc = torch.where(eligible & ~is_creation_leader, h, 0)
    incl1 = _seg_scan(
        is_leader, torch.stack([inc, (viable & (h != 0)).to(_i32)], dim=-1)
    )
    prefix1 = torch.where(same_prev[:, None], _shift1(incl1, 0), 0)
    S = prefix1[:, 0]

    # admission: S + h <= R0, written subtraction-side to stay in int32
    charged = eligible & ~is_creation_leader & (S <= R0_r - h)
    charged = charged | (is_creation_leader & charged_ldr_r)
    rem_b = torch.clamp_min(R0_r - S, 0)

    # real (charged-only) depletion prefix
    inc_chg = torch.where(charged & ~is_creation_leader, h, 0)
    decr = charged & ~is_creation_leader & (rem_b - h > 0)
    incl2 = _seg_scan(is_leader, torch.stack([inc_chg, decr.to(_i32)], dim=-1))
    prefix2 = torch.where(same_prev[:, None], _shift1(incl2, 0), 0)
    S_chg = prefix2[:, 0]
    rem_vis = torch.clamp_min(R0_r - S_chg, 0)  # true budget visible to j

    # token-only sticky flip
    z = viable & (eff_algo_r == 0) & (R0_r - S_chg == 0) & ~is_creation_leader
    z3 = scan.seg_scan(is_leader, z.to(_i32)[:, None])  # z's count in its group
    sticky_live = sticky0_r | (same_prev & _shift1(z, False))

    # ONE gather at the group end positions pulls every group total
    ends = torch.cat([incl1, incl2, z3], dim=1)[end_pos_G]  # [G, 5]
    any_hits = ends[:, 1] > 0
    total_charged = ends[:, 2]
    any_decr = ends[:, 3] > 0
    any_z = ends[:, 4] > 0

    # ---- sketch conservative update at [G] --------------------------------
    if sketch is not None:
        # each row takes max(counter, estimate + charged), saturating at
        # the counter dtype's max; non-sketch groups write 0 (a no-op on
        # non-negative counters). scatter-max commutes, so duplicate
        # indices and the fold's order do not matter.
        data_sk = sketch.data
        cmax = torch.iinfo(data_sk.dtype).max
        upd = torch.where(sk_g, sk_est + total_charged.to(_i64), 0)
        for upd_r, idx_rows in ((upd, sk_idx), (v_upd, v_idx)):
            upd_w = torch.clamp_max(upd_r, cmax).to(data_sk.dtype)
            for r, idx in enumerate(idx_rows):
                data_sk[r].scatter_reduce_(0, idx.long(), upd_w, reduce="amax")

    # ---- responses --------------------------------------------------------
    st_cached = torch.where(sticky_live, OVER, UNDER)

    # token, existing-style position (incl. followers of a creation)
    tok_status = torch.where(
        rem_vis == 0, OVER, torch.where(charged | (h == 0), st_cached, OVER)
    )
    tok_remaining = torch.where(
        rem_vis == 0, 0, torch.where(charged, rem_vis - h, rem_vis)
    )
    tok_reset = torch.where(existing_r, g_exp_r, now + g_durQ_r)

    # leaky, existing-style position
    lk_over = (rem_vis == 0) | (~charged & (h != 0))
    lk_status = torch.where(lk_over, OVER, UNDER)
    lk_remaining = tok_remaining
    lk_reset = torch.where(lk_over, now + rate_r, 0)

    g_lim_resp = torch.where(existing_r, g_limS_r, g_limQ_r)
    status = torch.where(eff_leaky_r, lk_status, tok_status)
    remaining = torch.where(eff_leaky_r, lk_remaining, tok_remaining)
    reset = torch.where(eff_leaky_r, lk_reset, tok_reset)

    # sliding / GCRA, existing-style position: no persisted status
    sg = eff_sld_r | eff_gcra_r
    sg_over = lk_over
    sg_status = lk_status
    sg_remaining = tok_remaining
    # GCRA per-row reset: the row's own TAT after every earlier charge of
    # its group plus its own n*T; a refused hit-carrying row reports the
    # earliest instant the same request could succeed
    S_eff = S_chg + torch.where(
        ~existing_r & charged_ldr_r & ~is_creation_leader, g_hits_r, 0
    )
    tat_row = gcra_tat0_r + S_eff.to(_i64) * gcra_T_r
    g_reset64 = (
        tat_row
        + h.to(_i64) * gcra_T_r
        - torch.where(sg_over & (h != 0), gcra_tau_r, 0)
    )
    gcra_reset_r = _clip(g_reset64, _I32_MIN, _I32_MAX).to(_i32)
    status = torch.where(sg, sg_status, status)
    remaining = torch.where(sg, sg_remaining, remaining)
    reset = torch.where(eff_sld_r, sld_reset_r, reset)
    reset = torch.where(eff_gcra_r, gcra_reset_r, reset)

    # creation leader overrides
    cl_status = torch.where(over_c_r, OVER, UNDER)
    cl_remaining = torch.where(
        over_c_r, torch.where(eff_leaky_r, 0, g_limQ_r), g_limQ_r - g_hits_r
    )
    cl_reset = torch.where(eff_leaky_r, 0, now + g_durQ_r)
    # GCRA creation: the fresh TAT after the leader's own charge
    gcra_cl = _clip(
        gcra_tat0_r + torch.where(charged_ldr_r, g_hits_r, 0).to(_i64) * gcra_T_r,
        _I32_MIN,
        _I32_MAX,
    ).to(_i32)
    cl_reset = torch.where(eff_gcra_r, gcra_cl, cl_reset)
    status = torch.where(is_creation_leader, cl_status, status)
    remaining = torch.where(is_creation_leader, cl_remaining, remaining)
    reset = torch.where(is_creation_leader, cl_reset, reset)

    # GLOBAL replica reads return the stored status verbatim
    status = torch.where(gnp_served, torch.where(sticky0_r, OVER, UNDER), status)
    remaining = torch.where(gnp_served, g_rem_r, remaining)
    reset = torch.where(gnp_served, g_exp_r, reset)

    # leaky zero-limit guard
    status = torch.where(leaky_zero_r, OVER, status)
    remaining = torch.where(leaky_zero_r, 0, remaining)
    reset = torch.where(leaky_zero_r, now + g_durS_r, reset)
    resp_limit = torch.where(leaky_zero_r, lim_q, g_lim_resp)

    # ---- quota-chain no-partial-debit ---------------------------------------
    # a chain ANY of whose rows is refused has every OTHER member's charge
    # rolled back: the group aggregates the writeback consumes are taken
    # again with those rows masked out. The refusing row keeps its own
    # bookkeeping (sticky flip, leaky touch), which is what makes the
    # all-singleton program byte-identical to the plain one.
    ldr_chg = torch.where(~existing & charged_ldr, g_hits, 0)
    if chain_id is not None:
        cid = chain_id.long()
        over_i = ((status == OVER) & valid).to(_i32)
        bad_cnt = torch.zeros(B, dtype=_i32, device=dev).index_add_(0, cid, over_i)
        m_ok = (bad_cnt[cid] - over_i) == 0
        incl_w = _seg_scan(
            is_leader,
            torch.stack(
                [
                    torch.where(charged & ~is_creation_leader & m_ok, h, 0),
                    (decr & m_ok).to(_i32),
                    (viable & (h != 0) & m_ok).to(_i32),
                ],
                dim=-1,
            ),
        )
        z3_w = scan.seg_scan(is_leader, (z & m_ok).to(_i32)[:, None])
        ends_w = torch.cat([incl_w, z3_w], dim=1)[end_pos_G]
        total_charged_w = ends_w[:, 0]
        any_decr_w = ends_w[:, 1] > 0
        any_hits_w = ends_w[:, 2] > 0
        any_z_w = ends_w[:, 3] > 0
        ldr_chg_w = torch.where(m_ok[lead_clip], ldr_chg, 0)  # the leader's mask
    else:
        total_charged_w, any_decr_w, any_hits_w, any_z_w = (
            total_charged, any_decr, any_hits, any_z
        )
        ldr_chg_w = ldr_chg

    # ---- state writeback at [G] -------------------------------------------
    # every hit charged to the group this batch, a creation leader's too
    # (explicit, so a rolled-back leader restores the whole budget)
    chg_all = total_charged_w + ldr_chg_w
    R0C = R0 + ldr_chg
    rem_final = R0C - chg_all

    sticky_final = sticky0 | any_z_w

    w_leaky = eff_leaky
    g_expire_new = torch.where(existing, g_exp, now + g_durQ)
    new_expire = torch.where(
        w_leaky,
        torch.where(
            existing,
            torch.where(any_decr_w, now + g_durS, g_exp),
            now + g_durQ,
        ),
        g_expire_new,
    )
    # sliding: expire pins the current window start (ws + 2d),
    # L_REMAINING the current count, L_TS the previous count
    d_eff64 = torch.where(
        existing, d_sld, torch.clamp(g_durQ.to(_i64), 1, SLIDING_MAX_DURATION_MS)
    )
    ws_eff64 = torch.where(existing, sld_ws, now64)
    sld_exp_new = _clip(ws_eff64 + 2 * d_eff64, _I32_MIN, _I32_MAX).to(_i32)
    new_expire = torch.where(eff_sld, sld_exp_new, new_expire)
    # GCRA: TAT' = max(TAT, now) + charged * T, clamped into int32
    gcra_tat_new = _clip(
        gcra_tat0 + chg_all.to(_i64) * gcra_T, _I32_MIN, _I32_MAX
    ).to(_i32)
    new_expire = torch.where(eff_gcra, gcra_tat_new, new_expire)

    new_rem = torch.where(eff_sld, torch.where(existing, sld_cur0, 0) + chg_all, rem_final)
    new_ts = torch.where(existing & w_leaky & ~any_hits_w, g_ts, now)
    new_ts = torch.where(eff_sld, torch.where(existing, sld_prev0, 0), new_ts)
    new_limit = torch.where(existing, g_limS, g_limQ)
    new_duration = torch.where(existing, g_durS, g_durQ)
    new_flags = (
        torch.where(w_leaky, FLAG_ALGO_LEAKY, 0)
        | torch.where(eff_sld, FLAG_ALGO_SLIDING, 0)
        | torch.where(eff_gcra, FLAG_ALGO_GCRA, 0)
        | torch.where((eff_algo == 0) & sticky_final, FLAG_STICKY_OVER, 0)
    )

    new_vals = torch.stack(
        [
            fp,
            new_expire,
            new_rem,
            new_ts,
            new_limit,
            new_duration,
            new_flags.to(_i32),
            low32(kh_G),  # L_KEYLOW: the key hash's low 32 bits
        ],
        dim=-1,
    ).to(_i32)  # [G, LANES]

    _writeback_apply(data, bkt, writer_G, way_G, new_vals, cand)

    resp = BatchResponse(
        status=status.to(_i32),
        limit=resp_limit.to(_i32),
        remaining=remaining.to(_i32),
        reset_time=reset.to(_i32),
    )
    stats = BatchStats(
        hits=(groups.valid & g_live).sum().to(_i32),
        misses=(groups.valid & ~g_live).sum().to(_i32),
        dropped=dropped_G.sum().to(_i32),
        evictions=evicted_G.sum().to(_i32),
    )
    return store, sketch, resp, stats


def decide(
    store: Store, req: BatchRequest, now
) -> Tuple[Store, BatchResponse, BatchStats]:
    """Exact-tier decide of one padded batch in ARBITRARY row order:
    sorts on the device (stable, invalid rows last), runs
    decide_presorted and unsorts the responses. For callers without a
    host presort; the engine presorts on the host. Mirrors
    gubernator_tpu/core/kernels.py:1458."""
    buckets = store.data.shape[0]
    sort_key = group_sort_key(req.key_hash, req.valid, buckets)
    order = torch.argsort(unsigned_order(sort_key), stable=True)
    kh_s = req.key_hash[order]
    req_stack = torch.stack(
        [
            req.hits,
            req.limit,
            req.duration,
            req.algo,
            req.gnp.to(_i32),
            req.valid.to(_i32),
        ],
        dim=-1,
    )[order]
    valid_s = req_stack[:, 5] != 0
    # invalid rows sorted to the tail repeat the last valid row's key so
    # the bucket stream stays monotonic (the presorted caller contract)
    n_valid = valid_s.sum()
    last_kh = kh_s[torch.clamp_min(n_valid - 1, 0)]
    kh_s = torch.where(valid_s, kh_s, last_kh)
    sorted_req = BatchRequest(
        key_hash=kh_s,
        hits=req_stack[:, 0],
        limit=req_stack[:, 1],
        duration=req_stack[:, 2],
        algo=req_stack[:, 3],
        gnp=req_stack[:, 4] != 0,
        valid=valid_s,
    )
    store, resp_s, stats = decide_presorted(store, sorted_req, now)
    resp_stack = torch.stack(
        [resp_s.status, resp_s.limit, resp_s.remaining, resp_s.reset_time], dim=-1
    )
    unsorted = torch.zeros_like(resp_stack)
    unsorted[order] = resp_stack
    resp = BatchResponse(
        status=unsorted[:, 0],
        limit=unsorted[:, 1],
        remaining=unsorted[:, 2],
        reset_time=unsorted[:, 3],
    )
    return store, resp, stats


def upsert_globals(
    store: Store,
    key_hash: torch.Tensor,  # int64 bit patterns [B]
    limit: torch.Tensor,  # int32[B]
    remaining: torch.Tensor,  # int32[B]
    reset_time: torch.Tensor,  # int32[B] engine-ms
    is_over: torch.Tensor,  # bool[B]
    valid: torch.Tensor,  # bool[B]
    duration: Optional[torch.Tensor] = None,  # int32[B] raw L_DURATION
    ts: Optional[torch.Tensor] = None,  # int32[B] raw L_TS
    flags: Optional[torch.Tensor] = None,  # int32[B] full L_FLAGS word
) -> Store:
    """Install windows for pre-hashed keys IN PLACE: the GLOBAL replica
    install and the sketch promoter's migration surface. Sorts by bucket
    on the device and writes through the decide's writeback; for
    duplicate keys the LAST in batch order wins. Without the optional
    lanes the entry is a token replica (zero duration/ts, a flags word of
    the sticky bit alone); with them the raw lanes land verbatim, so an
    entry of any algorithm reinstalls byte-exact. Mirrors
    gubernator_tpu/core/kernels.py:1518."""
    data = store.data
    buckets, W = data.shape
    ways = W // LANES
    B = key_hash.shape[0]
    dev = data.device

    sort_key = group_sort_key(key_hash, valid, buckets)
    order = torch.argsort(unsigned_order(sort_key), stable=True)
    skey = sort_key[order]
    bkt, fp = decode_sort_key(skey, buckets)
    valid_s = valid[order]
    stack = torch.stack(
        [limit, remaining, reset_time, is_over.to(_i32)], dim=-1
    )[order]

    cand = data.index_select(0, bkt).view(B, ways, LANES)
    match = (cand[:, :, L_TAG] == fp[:, None]) & valid_s[:, None]
    found = match.any(dim=1)
    fway = _first_true(match)
    evict_key = torch.where(cand[:, :, L_TAG] == 0, _I32_MIN, cand[:, :, L_EXPIRE])
    eway = _argmin_first(evict_key)

    zero = torch.zeros_like(bkt)
    if flags is None:
        flags_s = torch.where(stack[:, 3] != 0, FLAG_STICKY_OVER, 0).to(_i32)
    else:
        flags_s = flags.to(_i32)[order]
    dur_s = zero if duration is None else duration.to(_i32)[order]
    ts_s = zero if ts is None else ts.to(_i32)[order]
    new_vals = torch.stack(
        [fp, stack[:, 2], stack[:, 1], ts_s, stack[:, 0], dur_s, flags_s,
         low32(key_hash[order])],
        dim=-1,
    )

    # the writer of each (bucket, fp) group is its LAST member
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_last = torch.cat([skey[:-1] != skey[1:], true1])
    writer = valid_s & is_last
    is_b_leader = torch.cat([true1, bkt[1:] != bkt[:-1]])
    # drop/eviction counts are discarded: installs shed replica state,
    # not the owner-side admission state the over-admission alarm watches
    _writeback_delta_add(
        data, bkt, writer, found, fway, eway, new_vals, cand,
        is_b_leader, scan.segment_ends(is_b_leader),
    )
    return store


def upsert_windows(
    store: Store, key_hash, limit, remaining, reset_time, duration, ts, flags, valid
) -> Store:
    """Full-lane window install (the reference's upsert_windows_jit,
    kernels.py:1672): upsert_globals carrying the raw L_DURATION / L_TS /
    L_FLAGS words; the sticky bit comes from `flags`."""
    return upsert_globals(
        store, key_hash, limit, remaining, reset_time,
        (flags & FLAG_STICKY_OVER) != 0, valid,
        duration=duration, ts=ts, flags=flags,
    )


def pack_outputs(resp: BatchResponse, stats: BatchStats) -> torch.Tensor:
    """Responses + stats (hits, misses, dropped, evictions) as ONE
    int32[4*B+4] tensor, so the host fetches a single array per batch."""
    return torch.cat(
        [
            resp.status,
            resp.limit,
            resp.remaining,
            resp.reset_time,
            torch.stack([stats.hits, stats.misses, stats.dropped, stats.evictions]),
        ]
    )


def unpack_outputs(packed, B: int):
    """(status, limit, remaining, reset_time, hits, misses, dropped,
    evictions) from a pack_outputs array (numpy or tensor)."""
    return (
        packed[0:B],
        packed[B : 2 * B],
        packed[2 * B : 3 * B],
        packed[3 * B : 4 * B],
        packed[4 * B],
        packed[4 * B + 1],
        packed[4 * B + 2],
        packed[4 * B + 3],
    )
