"""Batched gang (pod-group) feasibility — "does the whole group fit under
every matched throttle simultaneously", one call per scheduling tick.

The port of the JAX package's ``ops/gang_check.py`` in torch ops, on
whichever device its operands lie. Semantics are DERIVED from the per-pod
4-step check (ops/check.py), not invented: gang admission is defined as
*sequential* per-pod admission — reserve member 1, check member 2 against
used+reserved+member 1, and so on (engine/gang.py ``sequential_gang_check``
is that oracle). Under the PreFilter flags (onEqual=False; step-3 onEqual
True for Throttle, False for ClusterThrottle) the sequential verdict is
order-independent and collapses to a GROUP-LEVEL form — for every throttle
column any member matches:

- **member exceeds** (step 1): some matched member alone exceeds the
  (class-resolved) threshold;
- **active** (step 2): the persisted ``st_*`` flags block some matched
  member (pod-count flag always; a request flag needs a member requesting
  that dim non-zero);
- **overflow** (steps 3+4 fused): ``used + reserved + group_total >
  threshold`` on the count dim or any request dim some member requests
  non-zero. With integer counts, step 3's ``au + prefix ≥ thr`` at the last
  member equals step 4's ``au + total > thr``; for requests, a positive
  final contribution makes saturation of any strict prefix imply overflow
  of the total, so both step-3 onEqual variants collapse to the same
  strict ``>``.

Thresholds arrive per class as ``[A, T]`` / ``[A, T, R]`` (row 0 = the
base effective thresholds; rows 1.. = the per-accel-class replacements,
ops/overrides.encode_class_thresholds) and each group carries a class
index: a gang is one job on one accelerator type.

Shapes: members [N] with matched cols [N,K] (-1 padded, the encoding of
``check_pods_gather``), group ids gid[N] in [0,G), groups padded to G.
Group totals materialize as [G,T]/[G,T,R] scatter-adds — G is a small
per-tick batch, so the footprint is G× the throttle state, not P×T.

Where torch differs from JAX: a gather raises on an out-of-range index
where JAX clamps, and a scatter raises where JAX drops it. So a col is
clamped into [0, T) for every index (the -1 pads read column 0 and are
masked by ``slot``; a col >= T reads row T - 1), and the group totals
scatter a zero for a col >= T: a zero added to a sum, or a 0 flag in a
max over 0/1 flags, leaves the target as JAX's dropped update does. The
per-group ``.at[].max`` becomes an int32
``scatter_reduce_`` ("amax"; there is no bool scatter) and the segment
sums int64 ``index_put_(accumulate=True)``, exact in any order. No float
appears.
"""

from __future__ import annotations

import torch

from .aggregate import _gather_ids


def _group_max(num_rows: int, index: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """bool[num_rows, *flags.shape[1:]]: for each row, whether any member
    mapped to it by ``index`` has its flag set (JAX ``.at[index].max``)."""
    out = torch.zeros((num_rows,) + tuple(flags.shape[1:]), dtype=torch.int32,
                      device=flags.device)
    idx = index.reshape((-1,) + (1,) * (flags.dim() - 1)).expand_as(flags)
    return out.scatter_reduce_(0, idx, flags.to(torch.int32), "amax") > 0


def _gang_classify(
    # member side
    pod_req,  # int64[N,R]
    pod_present,  # bool[N,R]
    member_valid,  # bool[N]
    cols,  # int32[N,K] (-1 padded)
    gid,  # int32[N] group index per member
    # throttle side (class-resolved thresholds + class-agnostic state)
    thr_valid,  # bool[T]
    cls_cnt,  # int64[A,T]
    cls_cnt_present,  # bool[A,T]
    cls_req,  # int64[A,T,R]
    cls_req_present,  # bool[A,T,R]
    st_cnt_throttled,  # bool[T]
    st_req_flag_present,  # bool[T,R]
    st_req_throttled,  # bool[T,R]
    au_cnt,  # int64[T] used+reserved counts (0 where absent)
    au_req,  # int64[T,R]
    # group side
    gclass,  # int32[G] per-group class row (0 = base)
    gvalid,  # bool[G]
    num_groups: int,
):
    """Core group classification → (ok bool[G], exceeds bool[G],
    active bool[G], blocked bool[G,T])."""
    G = num_groups
    T = thr_valid.shape[0]
    R = pod_req.shape[1]
    cm = cols.long().clamp_min(0)  # [N,K]: JAX's jnp.maximum(cols, 0)
    c = _gather_ids(cm, T)  # a col >= T reads row T - 1
    gid = gid.long()
    slot = (cols >= 0) & thr_valid[c] & member_valid[:, None]  # [N,K]
    gclass = gclass.long()
    mclass = gclass[gid]  # [N] class row per member

    pod_nonzero = pod_present & (pod_req != 0)  # [N,R]

    # --- step 1 per slot: member alone vs its class threshold ------------
    t_cnt = cls_cnt[mclass[:, None], c]  # [N,K]
    t_cnt_p = cls_cnt_present[mclass[:, None], c]
    t_req = cls_req[mclass[:, None], c]  # [N,K,R]
    t_req_p = cls_req_present[mclass[:, None], c]
    exceeds_slot = t_cnt_p & (t_cnt < 1)
    exceeds_slot |= torch.any(
        t_req_p & pod_present[:, None, :] & (pod_req[:, None, :] > t_req)
        & (pod_req[:, None, :] != 0),
        dim=-1,
    )
    exceeds_slot &= slot

    # --- step 2 per slot: persisted flags (class-agnostic) ---------------
    active_slot = st_cnt_throttled[c] | torch.any(
        st_req_flag_present[c] & st_req_throttled[c] & pod_nonzero[:, None, :],
        dim=-1,
    )
    active_slot &= slot

    # per-group reductions of the member-level verdicts (scatter-max)
    g_exceeds = _group_max(G, gid, torch.any(exceeds_slot, dim=1))
    g_active = _group_max(G, gid, torch.any(active_slot, dim=1))

    # --- group totals per (group, col): segment-sum scatter ---------------
    # a slot whose col is >= T scatters zeros: JAX drops that update
    scat = slot & (cm < T)
    gid2 = gid[:, None].expand_as(c)  # [N,K]
    g_cnt = torch.zeros((G, T), dtype=torch.int64, device=pod_req.device).index_put_(
        (gid2, c), scat.to(torch.int64), accumulate=True
    )
    slot_req = torch.where(scat[:, :, None], pod_req[:, None, :],
                           torch.zeros((), dtype=torch.int64, device=pod_req.device))
    g_req = torch.zeros((G, T, R), dtype=torch.int64, device=pod_req.device).index_put_(
        (gid2, c), slot_req, accumulate=True
    )
    # the [G,T,R] max: index_put_ has no max, so scatter over a [G*T, R] view
    g_nz = _group_max(
        G * T, (gid2 * T + c).reshape(-1),
        (scat[:, :, None] & pod_nonzero[:, None, :]).reshape(-1, R),
    ).reshape(G, T, R)
    affected = g_cnt > 0  # [G,T]

    # --- steps 3+4 fused at group granularity -----------------------------
    thr_cnt_g = cls_cnt[gclass]  # [G,T]
    thr_cnt_p_g = cls_cnt_present[gclass]
    thr_req_g = cls_req[gclass]  # [G,T,R]
    thr_req_p_g = cls_req_present[gclass]
    over_cnt = thr_cnt_p_g & (au_cnt[None, :] + g_cnt > thr_cnt_g)
    over_req = torch.any(
        thr_req_p_g & g_nz & (au_req[None, :, :] + g_req > thr_req_g), dim=-1
    )
    blocked = affected & (over_cnt | over_req)

    ok = gvalid & ~g_exceeds & ~g_active & ~torch.any(blocked, dim=1)
    return ok, g_exceeds & gvalid, g_active & gvalid, blocked & gvalid[:, None]


def gang_check(
    pod_req, pod_present, member_valid, cols, gid,
    thr_valid, cls_cnt, cls_cnt_present, cls_req, cls_req_present,
    st_cnt_throttled, st_req_flag_present, st_req_throttled,
    au_cnt, au_req, gclass, gvalid, num_groups: int,
):
    """Single-kind batched gang feasibility (see module docstring)."""
    return _gang_classify(
        pod_req, pod_present, member_valid, cols, gid,
        thr_valid, cls_cnt, cls_cnt_present, cls_req, cls_req_present,
        st_cnt_throttled, st_req_flag_present, st_req_throttled,
        au_cnt, au_req, gclass, gvalid, num_groups,
    )


def gang_check_both(kind_a: dict, kind_b: dict, gclass, gvalid, num_groups: int):
    """BOTH kinds' group feasibility in one call — the per-tick form the
    device manager serves (``kind_a``/``kind_b`` are dicts of the per-kind
    operands of :func:`gang_check` minus gclass/gvalid). Returns ``(ok,
    per-kind detail)`` where ``ok = ok_a ∧ ok_b`` and detail carries each
    kind's (ok, exceeds, active, blocked[G,T]) for reason construction."""
    out_a = _gang_classify(**kind_a, gclass=gclass, gvalid=gvalid, num_groups=num_groups)
    out_b = _gang_classify(**kind_b, gclass=gclass, gvalid=gvalid, num_groups=num_groups)
    return out_a[0] & out_b[0], (out_a, out_b)
