"""Residual-form fast check: per-cell compares only, no per-cell arithmetic.

Algebraic restatement of the 4-state check (``ops.check``): every addition in
steps 3-4 involves only pod-independent terms, so

    used + reserved + pod  >  threshold
⟺  pod  >  threshold - (used + reserved)          (exact in int64)

and step 3 (``used + reserved`` vs threshold) has no pod term at all. All
[T]/[T,R] quantities — saturation flags for both onEqual variants, the
step-4 residual, the count verdicts (the pod's count contribution is always
exactly 1) — are precomputed ONCE per state change by
``precompute_check_state``; the per-(pod,throttle,dim) inner loop is then
pure compares + boolean logic. This is the input of the dense CUDA kernel
(``ops/check_dense.py``).

Overflow note: ``threshold - (used+reserved)`` cannot overflow for any state
this framework produces (used/reserved are sums of non-negative pod amounts,
thresholds are admission-scale quantities ≪ 2^62).

Outputs are bit-identical to ``check_pods`` / ``check_pods_compact``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .classify import resolve_statuses, statuses_to_compact
from .schema import PodBatch, ThrottleState


@dataclass
class CheckPrecomp:
    """Pod-independent per-throttle tensors for the residual-form check."""

    valid: torch.Tensor  # bool[T]
    thr_req: torch.Tensor  # int64[T,R] — step-1 compare target
    thr_req_present: torch.Tensor  # bool[T,R]
    exceeds_cnt: torch.Tensor  # bool[T] — 1 > thr_cnt (step 1, onEqual=False)
    st_cnt: torch.Tensor  # bool[T] — status.throttled count flag
    st_req: torch.Tensor  # bool[T,R] — status.throttled request flag ∧ present
    sat_cnt_ge: torch.Tensor  # bool[T] — step-3 count, onEqual=True
    sat_cnt_gt: torch.Tensor  # bool[T] — step-3 count, onEqual=False
    sat_req_ge: torch.Tensor  # bool[T,R]
    sat_req_gt: torch.Tensor  # bool[T,R]
    resid: torch.Tensor  # int64[T,R] — thr - (used+reserved), step-4 target
    over_cnt_ge: torch.Tensor  # bool[T] — step-4 count, onEqual=True
    over_cnt_gt: torch.Tensor  # bool[T]


def precompute_check_state(state: ThrottleState) -> CheckPrecomp:
    au_cnt = state.used_cnt + state.res_cnt
    au_cnt_present = state.used_cnt_present | state.res_cnt_present
    au_req = state.used_req + state.res_req
    au_req_present = state.used_req_present | state.res_req_present

    sat_cnt_base = state.thr_cnt_present & au_cnt_present
    sat_req_base = state.thr_req_present & au_req_present

    return CheckPrecomp(
        valid=state.valid,
        thr_req=state.thr_req,
        thr_req_present=state.thr_req_present,
        exceeds_cnt=state.thr_cnt_present & (state.thr_cnt < 1),
        st_cnt=state.st_cnt_throttled,
        st_req=state.st_req_flag_present & state.st_req_throttled,
        sat_cnt_ge=sat_cnt_base & (au_cnt >= state.thr_cnt),
        sat_cnt_gt=sat_cnt_base & (au_cnt > state.thr_cnt),
        sat_req_ge=sat_req_base & (au_req >= state.thr_req),
        sat_req_gt=sat_req_base & (au_req > state.thr_req),
        resid=state.thr_req - au_req,
        # step-4 count: total count = au_cnt + 1, always present
        over_cnt_ge=state.thr_cnt_present & (au_cnt + 1 >= state.thr_cnt),
        over_cnt_gt=state.thr_cnt_present & (au_cnt + 1 > state.thr_cnt),
    )


def _classify_fast(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor,
                   on_equal: bool, step3_on_equal: bool) -> torch.Tensor:
    if pre.thr_req.shape[1] != pods.req.shape[1]:
        raise ValueError(
            f"resource-dim mismatch: precomp has R={pre.thr_req.shape[1]} "
            f"but pod batch has R={pods.req.shape[1]}"
        )
    pod_req = pods.req[:, None, :]  # [P,1,R]
    pod_present = pods.req_present[:, None, :]
    pod_nonzero = pod_present & (pod_req != 0)

    # step 1 — pod alone > threshold
    exceeds = pre.exceeds_cnt[None, :] | torch.any(
        pre.thr_req_present[None, :, :]
        & pod_nonzero
        & (pod_req > pre.thr_req[None, :, :]),
        dim=-1,
    )

    # step 2 — persisted flags
    st_active = pre.st_cnt[None, :] | torch.any(
        pre.st_req[None, :, :] & pod_nonzero, dim=-1
    )

    # step 3 — saturation (fully precomputed; only the pod-nonzero gate is
    # per-cell)
    sat_cnt = pre.sat_cnt_ge if step3_on_equal else pre.sat_cnt_gt
    sat_req = pre.sat_req_ge if step3_on_equal else pre.sat_req_gt
    saturated = sat_cnt[None, :] | torch.any(sat_req[None, :, :] & pod_nonzero, dim=-1)

    # step 4 — pod vs residual
    over_cnt = pre.over_cnt_ge if on_equal else pre.over_cnt_gt
    if on_equal:
        req_over = pod_req >= pre.resid[None, :, :]
    else:
        req_over = pod_req > pre.resid[None, :, :]
    insufficient = over_cnt[None, :] | torch.any(
        pre.thr_req_present[None, :, :] & pod_nonzero & req_over, dim=-1
    )

    affected = mask & pre.valid[None, :] & pods.valid[:, None]
    return resolve_statuses(exceeds, st_active | saturated, insufficient, affected)


def fast_check_pods(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor,
                    on_equal: bool = False, step3_on_equal: bool = True) -> torch.Tensor:
    """Residual-form full [P,T] classification — same contract as check_pods
    but taking the precomputed state."""
    return _classify_fast(pre, pods, mask, on_equal, step3_on_equal)


def fast_check_pods_compact(pre: CheckPrecomp, pods: PodBatch, mask: torch.Tensor,
                            on_equal: bool = False, step3_on_equal: bool = True):
    return statuses_to_compact(_classify_fast(pre, pods, mask, on_equal, step3_on_equal))


@dataclass
class CheckPrecompPacked:
    """CheckPrecomp repacked into THREE tensors for the indexed single-pod
    path: 3 gathers and one int64 compare plane instead of 13 gathers.

    Layouts:
      vals   int64[T,2,R] — [0]=thr_req (step-1 target), [1]=resid (step-4)
      planes bool [T,4,R] — [0]=thr_req_present, [1]=st_req,
                            [2]=sat_req_ge, [3]=sat_req_gt
      scal   bool [T,8]   — valid, exceeds_cnt, st_cnt, sat_cnt_ge,
                            sat_cnt_gt, over_cnt_ge, over_cnt_gt, pad
    """

    vals: torch.Tensor
    planes: torch.Tensor
    scal: torch.Tensor


def pack_check_state(pre: CheckPrecomp) -> CheckPrecompPacked:
    vals = torch.stack([pre.thr_req, pre.resid], dim=1)
    planes = torch.stack(
        [pre.thr_req_present, pre.st_req, pre.sat_req_ge, pre.sat_req_gt], dim=1
    )
    scal = torch.stack(
        [
            pre.valid, pre.exceeds_cnt, pre.st_cnt, pre.sat_cnt_ge,
            pre.sat_cnt_gt, pre.over_cnt_ge, pre.over_cnt_gt,
            torch.zeros_like(pre.valid),
        ],
        dim=1,
    )
    return CheckPrecompPacked(vals=vals, planes=planes, scal=scal)


def fast_check_pod_packed(
    packed: CheckPrecompPacked,
    pod_req: torch.Tensor,  # int64[R]
    pod_req_present: torch.Tensor,  # bool[R]
    thr_idx: torch.Tensor,  # int32[K]
    idx_valid: torch.Tensor,  # bool[K]
    on_equal: bool = False,
    step3_on_equal: bool = True,
) -> torch.Tensor:
    """Packed-layout single-pod check; bit-identical to
    ``fast_check_pod_indexed``."""
    idx = thr_idx.long()
    g_vals = packed.vals[idx]  # [K,2,R]
    g_planes = packed.planes[idx]  # [K,4,R]
    g_scal = packed.scal[idx]  # [K,8]

    pod_nonzero = pod_req_present & (pod_req != 0)  # [R]

    # one int64 compare plane: pod vs [thr_req, resid']. ``>=`` for step 4
    # under onEqual folds into ``>`` against resid-1 (exact in int64: resid
    # is thr-(used+res), admission-scale magnitudes)
    targets = g_vals
    if on_equal:
        targets = targets - torch.tensor([0, 1], dtype=targets.dtype, device=targets.device)[None, :, None]
    cmp = pod_req[None, None, :] > targets  # [K,2,R]

    sat_plane = g_planes[:, 2] if step3_on_equal else g_planes[:, 3]
    hits = torch.stack(
        [
            g_planes[:, 0] & cmp[:, 0],  # step 1: pod alone exceeds
            g_planes[:, 1],  # step 2: persisted flag
            sat_plane,  # step 3: saturation
            g_planes[:, 0] & cmp[:, 1],  # step 4: pod vs residual
        ],
        dim=1,
    )
    hits = torch.any(hits & pod_nonzero[None, None, :], dim=-1)  # [K,4]

    exceeds = g_scal[:, 1] | hits[:, 0]
    sat_cnt = g_scal[:, 3] if step3_on_equal else g_scal[:, 4]
    active = g_scal[:, 2] | hits[:, 1] | sat_cnt | hits[:, 2]
    over_cnt = g_scal[:, 5] if on_equal else g_scal[:, 6]
    insufficient = over_cnt | hits[:, 3]

    return resolve_statuses(exceeds, active, insufficient, idx_valid & g_scal[:, 0])


def fast_check_pod_indexed(
    pre: CheckPrecomp,
    pod_req: torch.Tensor,  # int64[R]
    pod_req_present: torch.Tensor,  # bool[R]
    thr_idx: torch.Tensor,  # int32[K] — affected-throttle rows (pad anywhere)
    idx_valid: torch.Tensor,  # bool[K] — live entries of thr_idx
    on_equal: bool = False,
    step3_on_equal: bool = True,
) -> torch.Tensor:
    """Single-pod PreFilter against ONLY its affected throttles: gathers the
    K precomputed rows and classifies in O(K·R), as the reference's hot path
    iterates just ``affectedThrottles(pod)`` (throttle_controller.go:349-397).

    Returns int8[K] statuses (CHECK_NOT_AFFECTED at padded slots).
    """
    idx = thr_idx.long()
    gathered = CheckPrecomp(**{f.name: getattr(pre, f.name)[idx] for f in fields(pre)})
    pods = PodBatch(
        valid=torch.ones((1,), dtype=torch.bool, device=pod_req.device),
        req=pod_req[None, :],
        req_present=pod_req_present[None, :],
    )
    return _classify_fast(gathered, pods, idx_valid[None, :], on_equal, step3_on_equal)[0]
