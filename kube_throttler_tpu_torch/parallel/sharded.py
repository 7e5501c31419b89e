"""The full update step on one device.

One "step" is a complete system tick: resolve every throttle's
time-varying threshold, re-aggregate ``used`` from the pod set, recompute
the throttled flags, and classify every pod × throttle admission cell —
a full reconcile pass fused with a full PreFilter sweep.

- ``full_update_step`` is the dense form over the [P,T] selector mask:
  the chunked masked column sums of ``ops/aggregate.py``, then the dense
  route of the batch check (``precompute_check_state`` → the
  hand-written ``check_dense`` kernel → ``statuses_to_compact``).
- ``full_update_step_gather`` is the sparse form over the [P,K] matched
  cols: an int64 scatter-add of the used sums and ``check_pods_gather``
  (the hand-written ``check_gather`` kernel).
  No [P,T] tensor exists anywhere.

The JAX package runs the same bodies inside ``shard_map`` with two psums;
those sharded forms are ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import torch

from ..ops import check_dense as _check_dense
from ..ops.aggregate import aggregate_used, throttled_flags
from ..ops.check import check_pods_gather, statuses_to_compact
from ..ops.fastcheck import precompute_check_state
from ..ops.overrides import OverrideSchedule, calculate_thresholds
from ..ops.schema import PodBatch, ThrottleState


def _derived_state(sched, now_ns, used_cnt, used_req, contrib,
                   res_cnt, res_cnt_present, res_req, res_req_present, thr_valid):
    """The throttle state the tick classifies against: thresholds resolved
    at ``now_ns``, the fresh used sums, and the throttled flags derived
    from both (reconcile's onEqual=True compare). Returns (state, st_cnt,
    st_req)."""
    thr_cnt, thr_cnt_present, thr_req, thr_req_present = calculate_thresholds(
        sched, now_ns
    )
    used_cnt_present = used_cnt > 0
    used_req_present = contrib > 0
    st_cnt, st_req, st_req_flag_present = throttled_flags(
        thr_cnt, thr_cnt_present, thr_req, thr_req_present,
        used_cnt, used_cnt_present, used_req, used_req_present,
    )
    state = ThrottleState(
        valid=thr_valid,
        thr_cnt=thr_cnt,
        thr_cnt_present=thr_cnt_present,
        thr_req=thr_req,
        thr_req_present=thr_req_present,
        used_cnt=used_cnt,
        used_cnt_present=used_cnt_present,
        used_req=used_req,
        used_req_present=used_req_present,
        res_cnt=res_cnt,
        res_cnt_present=res_cnt_present,
        res_req=res_req,
        res_req_present=res_req_present,
        st_cnt_throttled=st_cnt,
        st_req_throttled=st_req,
        st_req_flag_present=st_req_flag_present,
    )
    return state, st_cnt, st_req


def full_update_step(
    sched: OverrideSchedule,
    pods: PodBatch,
    mask: torch.Tensor,  # bool[P,T]
    counted: torch.Tensor,  # bool[P] — running pods that count into used
    res_cnt: torch.Tensor,
    res_cnt_present: torch.Tensor,
    res_req: torch.Tensor,
    res_req_present: torch.Tensor,
    thr_valid: torch.Tensor,  # bool[T]
    now_ns: torch.Tensor,  # 0-d int64
    *,
    on_equal: bool = False,
    step3_on_equal: bool = True,
):
    """One full tick over the dense [P,T] mask.

    Returns (counts int32[P,4], schedulable bool[P],
             used_cnt int64[T], used_req int64[T,R],
             st_cnt bool[T], st_req bool[T,R]).
    """
    used_cnt, used_req, contrib = aggregate_used(pods, mask, counted)
    state, st_cnt, st_req = _derived_state(
        sched, now_ns, used_cnt, used_req, contrib,
        res_cnt, res_cnt_present, res_req, res_req_present, thr_valid,
    )
    statuses = _check_dense.check_dense(
        precompute_check_state(state), pods, mask,
        on_equal=on_equal, step3_on_equal=step3_on_equal,
    )
    counts, schedulable = statuses_to_compact(statuses)
    return counts, schedulable, used_cnt, used_req, st_cnt, st_req


def used_from_cols(pods: PodBatch, cols: torch.Tensor, counted: torch.Tensor, T: int):
    """The sparse used aggregation: exact int64 scatter-adds of every
    counted pod's (count, requests, presence) into its matched cols.

    A slot that does not count (a -1 pad, an id outside [0, T), an
    uncounted or invalid pod) is routed to a spare row of its own pod,
    T + p, and the spare rows are sliced off: the JAX package's
    ``mode="drop"``, without every dropped add contending for one address.
    The requests scatter one resource dim at a time, so the per-slot
    source is an int64[P·K] column, not an int64[P·K,R] matrix.

    Returns (used_cnt int64[T], used_req int64[T,R], contrib int32[T,R]).
    """
    P, K = cols.shape
    R = pods.req.shape[1]
    dev = cols.device
    slot = (cols >= 0) & (cols < T) & (counted & pods.valid)[:, None]  # [P,K]
    spare = T + torch.arange(P, device=dev)[:, None]
    tgt = torch.where(slot, cols.long(), spare).reshape(-1)
    n = T + P
    used_cnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, tgt, torch.ones(P * K, dtype=torch.int64, device=dev)
    )[:T]
    acc_req = torch.zeros((R, n), dtype=torch.int64, device=dev)
    acc_ctb = torch.zeros((R, n), dtype=torch.int32, device=dev)
    present = pods.req_present.to(torch.int32)
    for r in range(R):
        acc_req[r].index_add_(0, tgt, pods.req[:, r, None].expand(P, K).reshape(-1))
        acc_ctb[r].index_add_(0, tgt, present[:, r, None].expand(P, K).reshape(-1))
    return used_cnt, acc_req[:, :T].T.contiguous(), acc_ctb[:, :T].T.contiguous()


def full_update_step_gather(
    sched: OverrideSchedule,
    pods: PodBatch,
    cols: torch.Tensor,  # int32[P,K] matched throttle cols per pod, -1 pads
    counted: torch.Tensor,  # bool[P]
    res_cnt: torch.Tensor,
    res_cnt_present: torch.Tensor,
    res_req: torch.Tensor,
    res_req_present: torch.Tensor,
    thr_valid: torch.Tensor,  # bool[T]
    now_ns: torch.Tensor,  # 0-d int64
    *,
    on_equal: bool = False,
    step3_on_equal: bool = True,
):
    """The SPARSE tick: the same fused reconcile+classify as
    ``full_update_step``, driven by the [P,K] matched-cols companion
    instead of the dense [P,T] mask — O(P·K·R) work. Returns the same
    tuple as ``full_update_step``."""
    used_cnt, used_req, contrib = used_from_cols(pods, cols, counted, thr_valid.shape[0])
    state, st_cnt, st_req = _derived_state(
        sched, now_ns, used_cnt, used_req, contrib,
        res_cnt, res_cnt_present, res_req, res_req_present, thr_valid,
    )
    counts, schedulable = check_pods_gather(
        state, pods, cols, on_equal=on_equal, step3_on_equal=step3_on_equal
    )
    return counts, schedulable, used_cnt, used_req, st_cnt, st_req
