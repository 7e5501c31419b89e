"""The least time the card could take for one call's work.

Bytes and operations are counted from the cell's own state, not from any
kernel: the live (pod, matched throttle) pairs, the dimensions each pod
requests and each throttle sets. Each input byte is read once and each
output byte written once. A kernel that is removed, fused or redesigned
changes the device time the share is taken over, never this count.

Inputs of a triage call (PreFilter against the written statuses):

- 8 B for each dimension a live pod requests;
- per kind, 4 B for each live pair (the matched throttle's index);
- per throttle, 8 B for each threshold family member it sets (the pod
  count, each request dimension), 8 B for each used member present
  (count, each dimension some counted pod requests), and 1 B for each
  throttled flag (the count's, each dimension the threshold sets).

Output: one verdict byte per live pod. Operations: the four steps on
the count and on each dimension the pod requests non-zero, four integer
operations each (three compares and the add of step 4), per pair.

The least time is the larger of bytes over the card's memory bandwidth
and operations over its integer rate (NVIDIA's data sheet, H100 SXM5:
3.35 TB/s HBM3, 1,979 TOP/s dense INT8), at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 1.979e15},
}


def _pod_side(pods) -> Tuple[int, np.ndarray]:
    """(request bytes of the live pods, non-zero dims per pod row)."""
    live = pods.alive
    nz = (pods.present & (pods.req != 0)).sum(axis=1)
    return int(8 * pods.present[live].sum()), nz


def _pair_ops(ks, nz: np.ndarray) -> int:
    return int(4 * (1 + nz[ks.pairs[0]]).sum())


def check_work(states: Sequence, pods) -> Tuple[int, int]:
    """(bytes, operations) of classifying every live pod against both
    kinds' written state. ``states`` are the reference's KindStates."""
    nbytes, nz = _pod_side(pods)
    ops = 0
    for ks in states:
        _, cnt_p, _, req_p = ks.thr
        u_cnt, _, contrib = ks.use
        nbytes += 4 * ks.pairs[0].size
        nbytes += 8 * int(cnt_p.sum() + req_p.sum())
        nbytes += 8 * int((u_cnt > 0).sum() + (contrib > 0).sum())
        nbytes += int(cnt_p.sum() + req_p.sum())
        ops += _pair_ops(ks, nz)
    nbytes += int(pods.alive.sum())
    return nbytes, ops


def least_s(nbytes: int, ops: int, card: str) -> Optional[float]:
    """The larger of the bytes bound and the ops bound on ``card``, or
    None for a card without published peaks here."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_per_s"], ops / peak["ops_per_s"])
