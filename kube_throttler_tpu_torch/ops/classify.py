"""The ordered 4-state resolution that every form of the admission check
shares: the status codes, the resolution of the four steps' booleans into
int8 statuses, the step logic over broadcast operands (``_classify_core``),
the shape checks, and the per-pod compaction of statuses into class counts.

``ops/check.py`` (the entry points and the dense forms), the plain version
of the ``check_gather`` kernel (``ops/check_gather.py``) and the residual
form (``ops/fastcheck.py``) import it, so the dependency runs one way:
``check`` → ``check_gather`` → ``classify``.
"""

from __future__ import annotations

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


def _check_cols(pods: PodBatch, cols: torch.Tensor) -> None:
    if cols.ndim != 2 or cols.shape[0] != pods.req.shape[0]:
        raise ValueError(
            f"cols shape {tuple(cols.shape)} != (P={pods.req.shape[0]}, K)"
        )


#: cells of [P,T] statuses compacted at once: torch sums a bool operand
#: through an int32 copy of it, so a block of rows bounds that copy (256 MB)
_COMPACT_CHUNK_CELLS = 64 << 20


def statuses_to_compact(statuses: torch.Tensor):
    """[P,T] statuses → (counts int32[P,4], schedulable bool[P]); the
    schedulable gate mirrors PreFilter (plugin.go:177-180). Shared by every
    compact path so the gate can never silently diverge between kernels.
    Rows are compacted in blocks of at most ``_COMPACT_CHUNK_CELLS`` cells."""
    step = max(1, _COMPACT_CHUNK_CELLS // max(statuses.shape[1], 1))
    parts = [
        torch.stack([torch.sum(blk == c, dim=1, dtype=torch.int32) for c in range(4)], dim=1)
        for blk in statuses.split(step)
    ]
    counts = parts[0] if len(parts) == 1 else torch.cat(parts)
    schedulable = (
        counts[:, CHECK_ACTIVE] + counts[:, CHECK_INSUFFICIENT] + counts[:, CHECK_POD_EXCEEDS]
    ) == 0
    return counts, schedulable
