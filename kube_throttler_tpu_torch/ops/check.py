"""The batched ordered 4-state admission check — the framework's hot kernel.

Reproduces ``check_throttled_for`` (reference throttle_types.go:128-153,
clusterthrottle_types.go:30-55) for every (pod, throttle) pair at once:

    1. pod alone > threshold                  → POD_EXCEEDS (onEqual=False)
    2. persisted status.throttled flags hit   → ACTIVE
    3. used + reserved saturates threshold    → ACTIVE
       (onEqual hardcoded True for Throttle — throttle_types.go:143 —
        caller's flag for ClusterThrottle — clusterthrottle_types.go:45)
    4. used + reserved + pod overflows        → INSUFFICIENT (caller's flag)
    else                                      → NOT_THROTTLED

Presence-mask algebra (absent ≠ zero) follows resource_amount.go:127-159:
a comparison only fires when the dimension is present in BOTH the threshold
and the used side; "blocks this pod" additionally requires the pod to
request that resource non-zero (resource_amount.go:46-65) — except the
pod-count flag, which always blocks.

Shapes: throttle state [T]/[T,R], pods [P]/[P,R], selector mask [P,T].
Every form broadcasts pod-side [P,1,R] against throttle-side [1,T,R]
(dense) or gathered [P,K,R] (sparse) operands and reduces over the last
(R) dimension. Three output forms:

- ``check_pods``          → int8[P,T] full classification (explain path,
  oracle diffing, reason-string formatting for blocked pods);
- ``check_pods_compact``  → int32[P,4] per-pod class counts + bool[P]
  schedulable;
- ``check_pods_gather``   → same outputs from int32[P,K] matched-cols lists
  instead of a mask: computes P×K×R, the batch path the device manager
  dispatches when masks are sparse (K ≪ T).

Statuses are int8 and counts int32 on every path: the resolution writes
into an int8 tensor instead of ``torch.where`` over Python scalars, which
would promote to int64.
"""

from __future__ import annotations

import os

import torch

from .schema import PodBatch, ThrottleState

CHECK_NOT_AFFECTED = -1
CHECK_NOT_THROTTLED = 0
CHECK_ACTIVE = 1
CHECK_INSUFFICIENT = 2
CHECK_POD_EXCEEDS = 3

STATUS_NAMES = {
    CHECK_NOT_AFFECTED: "not-affected",
    CHECK_NOT_THROTTLED: "not-throttled",
    CHECK_ACTIVE: "active",
    CHECK_INSUFFICIENT: "insufficient",
    CHECK_POD_EXCEEDS: "pod-requests-exceeds-threshold",
}


def _cmp(u, t, on_equal: bool):
    return u >= t if on_equal else u > t


def resolve_statuses(exceeds, active, insufficient, affected) -> torch.Tensor:
    """The ordered resolution into int8 statuses: exceeds, then active,
    then insufficient, else not-throttled; NOT_AFFECTED where ``affected``
    is False. Operands broadcast together."""
    shape = torch.broadcast_shapes(
        exceeds.shape, active.shape, insufficient.shape, affected.shape
    )
    out = torch.full(shape, CHECK_NOT_THROTTLED, dtype=torch.int8, device=exceeds.device)
    out.masked_fill_(insufficient, CHECK_INSUFFICIENT)
    out.masked_fill_(active, CHECK_ACTIVE)
    out.masked_fill_(exceeds, CHECK_POD_EXCEEDS)
    out.masked_fill_(~affected, CHECK_NOT_AFFECTED)
    return out


def _classify_core(
    pod_req, pod_present, pod_nonzero,
    thr_cnt, thr_cnt_present, thr_req, thr_req_present,
    st_cnt_throttled, st_req_flag_present, st_req_throttled,
    au_cnt, au_cnt_present, au_req, au_req_present,
    affected, on_equal: bool, step3_on_equal: bool,
):
    """The 4-step ordered resolution on broadcast-compatible operands:
    pod side [P,1,R], throttle side [1,T,R] (dense) or [P,K,R] (gather);
    the count-side operands drop the trailing R. One body ⇒ the dense and
    sparse forms cannot drift."""
    # --- step 1: pod alone vs threshold (onEqual=False) -------------------
    # pod count is always 1 and always present
    exceeds_cnt = thr_cnt_present & (thr_cnt < 1)
    exceeds_req = torch.any(
        thr_req_present & pod_present & (pod_req > thr_req) & (pod_req != 0), dim=-1
    )
    exceeds = exceeds_cnt | exceeds_req

    # --- step 2: persisted throttled flags --------------------------------
    st_active = st_cnt_throttled | torch.any(
        st_req_flag_present & st_req_throttled & pod_nonzero, dim=-1
    )

    # --- step 3: used + reserved saturation -------------------------------
    sat_cnt = thr_cnt_present & au_cnt_present & _cmp(au_cnt, thr_cnt, step3_on_equal)
    sat_req = torch.any(
        thr_req_present
        & au_req_present
        & _cmp(au_req, thr_req, step3_on_equal)
        & pod_nonzero,
        dim=-1,
    )
    saturated = sat_cnt | sat_req

    # --- step 4: used + reserved + pod overflow ---------------------------
    # pod contributes count 1 (always present) and its requests
    tot_cnt = au_cnt + 1
    tot_req = au_req + pod_req
    tot_req_present = au_req_present | pod_present

    over_cnt = thr_cnt_present & _cmp(tot_cnt, thr_cnt, on_equal)
    over_req = torch.any(
        thr_req_present
        & tot_req_present
        & _cmp(tot_req, thr_req, on_equal)
        & pod_nonzero,
        dim=-1,
    )
    insufficient = over_cnt | over_req

    return resolve_statuses(exceeds, st_active | saturated, insufficient, affected)


def _check_dims(state: ThrottleState, pods: PodBatch) -> None:
    # DimRegistry capacity may have doubled between the throttle-state and
    # pod-batch encodes; fail with an actionable message instead of an
    # opaque broadcast error
    if state.thr_req.shape[1] != pods.req.shape[1]:
        raise ValueError(
            f"resource-dim mismatch: throttle state has R={state.thr_req.shape[1]} "
            f"but pod batch has R={pods.req.shape[1]}; the dim registry grew — "
            "re-encode both against the same capacity"
        )


def _classify(state: ThrottleState, pods: PodBatch, mask: torch.Tensor,
              on_equal: bool, step3_on_equal: bool) -> torch.Tensor:
    """Core classification → int8[P,T]. The flags pick the variant."""
    _check_dims(state, pods)
    if tuple(mask.shape) != (pods.req.shape[0], state.thr_req.shape[0]):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != (P={pods.req.shape[0]}, T={state.thr_req.shape[0]})"
        )
    # pod-side broadcast views: [P,1,R] vs throttle [1,T,R]
    pod_req = pods.req[:, None, :]
    pod_present = pods.req_present[:, None, :]
    pod_nonzero = pod_present & (pod_req != 0)

    return _classify_core(
        pod_req, pod_present, pod_nonzero,
        state.thr_cnt[None, :], state.thr_cnt_present[None, :],
        state.thr_req[None, :, :], state.thr_req_present[None, :, :],
        state.st_cnt_throttled[None, :],
        state.st_req_flag_present[None, :, :], state.st_req_throttled[None, :, :],
        (state.used_cnt + state.res_cnt)[None, :],
        (state.used_cnt_present | state.res_cnt_present)[None, :],
        (state.used_req + state.res_req)[None, :, :],
        (state.used_req_present | state.res_req_present)[None, :, :],
        mask & state.valid[None, :] & pods.valid[:, None],
        on_equal, step3_on_equal,
    )


def check_pods(state: ThrottleState, pods: PodBatch, mask: torch.Tensor,
               on_equal: bool = False, step3_on_equal: bool = True) -> torch.Tensor:
    """Full [P,T] classification (int8)."""
    return _classify(state, pods, mask, on_equal, step3_on_equal)


def statuses_to_compact(statuses: torch.Tensor):
    """[P,T] statuses → (counts int32[P,4], schedulable bool[P]); the
    schedulable gate mirrors PreFilter (plugin.go:177-180). Shared by every
    compact path so the gate can never silently diverge between kernels."""
    counts = torch.stack(
        [torch.sum(statuses == c, dim=1, dtype=torch.int32) for c in range(4)], dim=1
    )
    schedulable = (
        counts[:, CHECK_ACTIVE] + counts[:, CHECK_INSUFFICIENT] + counts[:, CHECK_POD_EXCEEDS]
    ) == 0
    return counts, schedulable


def _compact(state: ThrottleState, pods: PodBatch, mask: torch.Tensor,
             on_equal: bool, step3_on_equal: bool):
    return statuses_to_compact(_classify(state, pods, mask, on_equal, step3_on_equal))


def check_step(state: ThrottleState, pods: PodBatch, mask: torch.Tensor):
    """Forward step with the PreFilter defaults (onEqual=False, Throttle
    kind) — returns (counts, schedulable)."""
    return _compact(state, pods, mask, False, True)


def check_pods_compact(state: ThrottleState, pods: PodBatch, mask: torch.Tensor,
                       on_equal: bool = False, step3_on_equal: bool = True):
    """Per-pod class counts: ``(counts int32[P,4], schedulable bool[P])``
    where counts[p,c] is the number of affected throttles classifying pod
    p as class c (NOT_THROTTLED/ACTIVE/INSUFFICIENT/POD_EXCEEDS), and
    schedulable[p] mirrors PreFilter's gate: no active/insufficient/exceeds
    throttle (plugin.go:177-180)."""
    return _compact(state, pods, mask, on_equal, step3_on_equal)


def _check_cols(pods: PodBatch, cols: torch.Tensor) -> None:
    if cols.ndim != 2 or cols.shape[0] != pods.req.shape[0]:
        raise ValueError(
            f"cols shape {tuple(cols.shape)} != (P={pods.req.shape[0]}, K)"
        )


def check_pods_gather(state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
                      on_equal: bool = False, step3_on_equal: bool = True):
    """Sparse batch check: ``cols`` int32[P,K] lists each pod's matched
    throttle columns (-1 pads empty slots). Gathers the K throttle rows per
    pod and runs the same 4-step resolution as ``check_pods_compact`` over
    [P,K,R] instead of [P,T,R].

    Returns ``(counts int32[P,4], schedulable bool[P])``, identical to
    ``check_pods_compact`` given a cols/mask pair describing the same
    matches (parity-tested)."""
    _check_dims(state, pods)
    _check_cols(pods, cols)
    return statuses_to_compact(
        _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal)
    )


def _gather_statuses(state, pods, cols, on_equal, step3_on_equal):
    """Shared body of the sparse gather forms: int8[P,K] per-slot statuses
    (CHECK_NOT_AFFECTED for padded/invalid slots). Pad slots (-1) are
    clamped to col 0 before the gather — torch raises on the negative
    index that a JAX gather would clamp — and masked out by ``slot``."""
    c = torch.clamp(cols, min=0).long()  # [P,K]
    slot = (cols >= 0) & state.valid[c] & pods.valid[:, None]

    pod_req = pods.req[:, None, :]  # [P,1,R]
    pod_present = pods.req_present[:, None, :]
    pod_nonzero = pod_present & (pod_req != 0)

    return _classify_core(
        pod_req, pod_present, pod_nonzero,
        state.thr_cnt[c], state.thr_cnt_present[c],
        state.thr_req[c], state.thr_req_present[c],
        state.st_cnt_throttled[c],
        state.st_req_flag_present[c], state.st_req_throttled[c],
        (state.used_cnt + state.res_cnt)[c],
        (state.used_cnt_present | state.res_cnt_present)[c],
        (state.used_req + state.res_req)[c],
        (state.used_req_present | state.res_req_present)[c],
        slot, on_equal, step3_on_equal,
    )


# Peak-footprint governor for the sparse gather forms: a [P,K] dispatch
# materializes several gathered [P,K,R] operands, so an unbounded P×K×R
# runs in P-blocks of at most KT_GATHER_CHUNK_ELEMS elements (bit-identical
# statuses). 64M elements ≈ 512 MB per int64 operand.
try:
    _GATHER_CHUNK_ELEMS = int(
        os.environ.get("KT_GATHER_CHUNK_ELEMS", str(64 * 1024 * 1024))
    )
except ValueError:
    # a malformed override must not kill module import; fall back to the
    # 64M default
    _GATHER_CHUNK_ELEMS = 64 * 1024 * 1024


def _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal):
    """_gather_statuses, chunked over P when the gather footprint exceeds
    _GATHER_CHUNK_ELEMS; the blocks run in order into one int8[P,K]."""
    P, K = cols.shape
    R = pods.req.shape[1]
    if P * max(K, 1) * R <= _GATHER_CHUNK_ELEMS:
        return _gather_statuses(state, pods, cols, on_equal, step3_on_equal)
    pb = max(1, _GATHER_CHUNK_ELEMS // (max(K, 1) * R))
    out = torch.empty((P, K), dtype=torch.int8, device=cols.device)
    for s in range(0, P, pb):
        e = min(P, s + pb)
        block = PodBatch(
            valid=pods.valid[s:e], req=pods.req[s:e], req_present=pods.req_present[s:e]
        )
        out[s:e] = _gather_statuses(state, block, cols[s:e], on_equal, step3_on_equal)
    return out


def check_pods_gather_statuses(
    state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
    on_equal: bool = False, step3_on_equal: bool = True,
):
    """``check_pods_gather`` returning the raw int8[P,K] per-slot statuses
    instead of compact counts — the micro-batching pre_filter front-end
    needs each pod's per-throttle classification to build reference reason
    strings (plugin.go:182-214), not just the verdict."""
    _check_dims(state, pods)
    _check_cols(pods, cols)
    return _gather_statuses_blocked(state, pods, cols, on_equal, step3_on_equal)
