"""Used-amount aggregation and streaming delta updates.

The reference recomputes ``status.used`` per reconcile by scanning every pod
in the namespace and summing matched, counted pods' amounts
(throttle_controller.go:103-119). Batched here as one masked column sum
over the [P,T] selector mask — all throttles at once — plus a scatter-add
path for streaming pod events that avoids the full recomputation.

Presence bookkeeping: ``contrib[t,r]`` counts how many contributing pods
carry resource r, so removals keep presence exact (a bool OR could never be
un-set); ``used.resourceCounts`` is present iff ≥1 pod contributed (the Go
accumulator only materializes counts after the first Add —
resource_amount.go:91-110 over throttle_controller.go:116-119).

Every sum is an exact int64 integer sum, on either device: the masked
column sums walk the pods in chunks (no float dot, no [P,T,R] tensor), and
the scatters are int64 ``index_add_``, which is exact in any order. Ids
follow the JAX package's indexing: a negative id counts from the end, a
scatter drops an id outside [0, T) (callers pad with T on purpose), and a
gather clamps it into range. torch would raise on those ids, so they are
mapped here before any scatter or gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from .schema import PodBatch

#: cap on the [chunk,T,R] int64 temporary of the dense masked column sum
DENSE_CHUNK_BYTES = 256 << 20


def _wrap(ids: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's index normalization: a negative id counts from the end."""
    return torch.where(ids < 0, ids + n, ids).long()


def _gather_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Ids for a gather over ``n`` rows, clamped into range as JAX does."""
    return _wrap(ids, n).clamp(0, n - 1)


def _scatter_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Ids for a scatter into ``n`` rows plus one spare row: an id outside
    [0, n) lands in row ``n``, which the caller slices off (JAX's
    ``mode="drop"``)."""
    w = _wrap(ids, n)
    return torch.where((w >= 0) & (w < n), w, n)


def _with_spare_row(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with one zero row appended (the scatter's drop row)."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _chunk_rows(T: int, R: int) -> int:
    return max(1, DENSE_CHUNK_BYTES // max(T * R * 8, 1))


def _masked_sums(m: torch.Tensor, keep: torch.Tensor, req: torch.Tensor,
                 present: torch.Tensor, chunk_rows: Optional[int] = None):
    """(used_cnt int64[T], used_req int64[T,R], contrib int32[T,R]) over
    the rows of the bool[P,T] mask ``m`` that ``keep`` bool[P] admits, for
    the pod rows ``req`` int64[P,R] / ``present`` bool[P,R].

    Walks P in chunks of ``chunk_rows`` (default: a [chunk,T,R] int64
    temporary of at most ``DENSE_CHUNK_BYTES``); every temporary is a
    chunk's, including the int64 copy torch makes of a bool operand it
    sums. The same code on either device."""
    P, T = m.shape
    R = req.shape[1]
    step = chunk_rows or _chunk_rows(T, R)
    used_cnt = torch.zeros(T, dtype=torch.int64, device=m.device)
    used_req = torch.zeros((T, R), dtype=torch.int64, device=m.device)
    contrib = torch.zeros((T, R), dtype=torch.int32, device=m.device)
    for s in range(0, P, step):
        mb = m[s : s + step] & keep[s : s + step, None]  # [c,T]
        used_cnt += mb.sum(dim=0, dtype=torch.int64)  # each pod contributes count 1
        mb = mb[:, :, None]
        used_req += torch.where(mb, req[s : s + step, None, :], 0).sum(dim=0)
        contrib += (mb & present[s : s + step, None, :]).sum(dim=0, dtype=torch.int32)
    return used_cnt, used_req, contrib


def aggregate_used(pods: PodBatch, mask: torch.Tensor, counted: torch.Tensor):
    """Full recompute of used amounts for every throttle.

    Args:
      pods: padded pod batch (requests of ALL pods, scheduled or not).
      mask: bool[P,T] selector match matrix.
      counted: bool[P] — shouldCountIn ∧ non-terminated ∧ valid
        (schedulerName match, nodeName set — throttle_controller.go:217-219).

    Returns (used_cnt int64[T], used_req int64[T,R], contrib int32[T,R]).
    """
    return _masked_sums(mask, counted, pods.req, pods.req_present)


def apply_pod_delta(
    used_cnt: torch.Tensor,
    used_req: torch.Tensor,
    contrib: torch.Tensor,
    throttle_ids: torch.Tensor,  # int32[K] — rows to update (may repeat; pad with T)
    sign: torch.Tensor,  # int64[K] — +1 add / -1 remove / 0 padding
    pod_req: torch.Tensor,  # int64[R] — the pod's effective request
    pod_req_present: torch.Tensor,  # bool[R]
):
    """Streaming update: one pod added/removed from K affected throttles.

    ``throttle_ids`` may be padded with out-of-range indices (dropped).
    Returns new tensors; the inputs are not written."""
    return apply_pod_deltas_batched(
        used_cnt, used_req, contrib, throttle_ids[None, :], sign[None, :],
        pod_req[None, :], pod_req_present[None, :],
    )


def apply_pod_deltas_batched(
    used_cnt: torch.Tensor,
    used_req: torch.Tensor,
    contrib: torch.Tensor,
    throttle_ids: torch.Tensor,  # int32[N,K] — per-event target rows (pad with T)
    sign: torch.Tensor,  # int64[N,K] — +1/-1/0 per (event, slot)
    pod_req: torch.Tensor,  # int64[N,R]
    pod_req_present: torch.Tensor,  # bool[N,R]
):
    """N pod events applied as one flat [N·K] scatter-add.

    Scatter-adds commute and associate exactly in int64, so this equals N
    sequential ``apply_pod_delta`` calls. Returns new tensors (the inputs
    are not written): the scatter runs into a copy with one spare row for
    the dropped ids, sliced off at the end."""
    n, k = throttle_ids.shape
    T, R = used_req.shape
    flat_ids = _scatter_ids(throttle_ids.reshape(n * k), T)
    flat_sign = sign.reshape(n * k)
    req_updates = (sign[:, :, None] * pod_req[:, None, :]).reshape(n * k, R)
    contrib_updates = (
        sign[:, :, None] * pod_req_present[:, None, :].to(torch.int64)
    ).to(torch.int32).reshape(n * k, R)
    used_cnt = _with_spare_row(used_cnt).index_add_(0, flat_ids, flat_sign)[:T]
    used_req = _with_spare_row(used_req).index_add_(0, flat_ids, req_updates)[:T]
    contrib = _with_spare_row(contrib).index_add_(0, flat_ids, contrib_updates)[:T]
    return used_cnt, used_req, contrib


def _cols_sums(pods: PodBatch, mask: torch.Tensor, counted: torch.Tensor,
               cols: torch.Tensor):
    """The masked sums of the gathered columns ``mask[:, cols]``."""
    return _masked_sums(mask[:, _gather_ids(cols, mask.shape[1])], counted & pods.valid,
                        pods.req, pods.req_present)


def rebase_cols(
    agg_cnt: torch.Tensor,  # int64[T]
    agg_req: torch.Tensor,  # int64[T,R]
    contrib: torch.Tensor,  # int32[T,R]
    pods: PodBatch,
    mask: torch.Tensor,  # bool[P,T]
    counted: torch.Tensor,  # bool[P]
    cols: torch.Tensor,  # int32[K] — columns to recompute (pad with T → dropped)
):
    """Recompute the used-aggregates of K specific throttle columns from
    scratch (selector/threshold edits invalidate a column's incremental
    aggregate — the membership set changed, so deltas no longer apply).

    One masked [P,K] reduction, then a row write of the K columns into
    copies of the aggregates (pad columns go to a spare row, sliced off)."""
    cnt, req, ctb = _cols_sums(pods, mask, counted, cols)
    T = agg_cnt.shape[0]
    tgt = _scatter_ids(cols, T)

    def put(t, rows):
        out = _with_spare_row(t)
        out[tgt] = rows
        return out[:T]

    return put(agg_cnt, cnt), put(agg_req, req), put(contrib, ctb)


def aggregate_cols(
    pods: PodBatch,
    mask: torch.Tensor,  # bool[P,T]
    counted: torch.Tensor,  # bool[P]
    cols: torch.Tensor,  # int32[K] — columns to recompute (pad freely)
):
    """Used-aggregates of K specific columns, RETURNED rather than scattered
    (``rebase_cols`` minus the write). A pad column reads the clamped
    column, as the JAX gather does."""
    return _cols_sums(pods, mask, counted, cols)


def throttled_flags(
    thr_cnt: torch.Tensor,
    thr_cnt_present: torch.Tensor,
    thr_req: torch.Tensor,
    thr_req_present: torch.Tensor,
    used_cnt: torch.Tensor,
    used_cnt_present: torch.Tensor,
    used_req: torch.Tensor,
    used_req_present: torch.Tensor,
):
    """status.throttled = threshold.IsThrottled(used, onEqual=True) batched
    over throttles (reconcile's flag computation,
    throttle_controller.go:133).

    Returns (cnt_flag bool[T], req_flag bool[T,R], req_flag_present bool[T,R]);
    flag-map keys are exactly the threshold's request keys
    (resource_amount.go:147-156).
    """
    cnt_flag = thr_cnt_present & used_cnt_present & (used_cnt >= thr_cnt)
    req_flag = thr_req_present & used_req_present & (used_req >= thr_req)
    return cnt_flag, req_flag, thr_req_present
