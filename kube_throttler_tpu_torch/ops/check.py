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
  dispatches when masks are sparse (K ≪ T). On CUDA tensors it and
  ``check_pods_gather_statuses`` launch the hand-written ``check_gather``
  kernel (``ops/check_gather.py``), which also holds their plain
  version.

Statuses are int8 and counts int32 on every path: the resolution writes
into an int8 tensor instead of ``torch.where`` over Python scalars, which
would promote to int64.
"""

from __future__ import annotations

import torch

from .check_gather import check_gather
from .classify import (  # noqa: F401  (the status names stay importable from here)
    CHECK_ACTIVE,
    CHECK_INSUFFICIENT,
    CHECK_NOT_AFFECTED,
    CHECK_NOT_THROTTLED,
    CHECK_POD_EXCEEDS,
    STATUS_NAMES,
    _check_dims,
    _classify_core,
    statuses_to_compact,
)
from .schema import PodBatch, ThrottleState


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


def check_pods_gather(state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
                      on_equal: bool = False, step3_on_equal: bool = True):
    """Sparse batch check: ``cols`` int32[P,K] lists each pod's matched
    throttle columns (-1 pads empty slots). Gathers the K throttle rows per
    pod and runs the same 4-step resolution as ``check_pods_compact`` over
    [P,K,R] instead of [P,T,R].

    Returns ``(counts int32[P,4], schedulable bool[P])``, identical to
    ``check_pods_compact`` given a cols/mask pair describing the same
    matches (parity-tested). On CUDA tensors it is two launches of
    ``csrc/check_gather.cu`` (``ops/check_gather.py``): the pack of the
    state's rows into records, then the check over them; on CPU tensors,
    the plain version (``check_gather_reference`` there)."""
    return check_gather(state, pods, cols, on_equal, step3_on_equal)


def check_pods_gather_statuses(
    state: ThrottleState, pods: PodBatch, cols: torch.Tensor,
    on_equal: bool = False, step3_on_equal: bool = True,
):
    """``check_pods_gather`` returning the raw int8[P,K] per-slot statuses
    instead of compact counts — the micro-batching pre_filter front-end
    needs each pod's per-throttle classification to build reference reason
    strings (plugin.go:182-214), not just the verdict. Dispatched like
    ``check_pods_gather``, through the ``check_gather`` kernel's wrapper."""
    return check_gather(state, pods, cols, on_equal, step3_on_equal, statuses=True)
