"""Time-varying threshold resolution on the device.

``calculate_threshold`` (reference throttle_types.go:65-106) picks, at time
``now``, the first-active override per dimension; if ANY override is active
the merged result REPLACES the whole spec threshold (dims absent from the
merge become absent). Overrides whose RFC3339 strings fail to parse are
skipped (messages are host-side static data — they depend only on the spec).

Encoded as a padded override schedule: [T,O] begin/end nanosecond bounds
(±int64 sentinels for open ends / parse errors) plus per-override threshold
tensors. Resolution is a pure function of ``now_ns``: every throttle's
effective threshold in a few tensor ops, no host loop.

"First" is the smallest override index whose candidate flag is set: an
``amin`` over ``where(cand, index, O - 1)``, then a gather of that slot. The
Go loop's iteration order (throttle_types.go:76-95) is the index order, and
every value stays exact int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..api.types import RFC3339ParseError, ThrottleSpecBase
from ..quantity import to_milli
from .schema import DimRegistry, _tensors

NS_MIN = np.int64(np.iinfo(np.int64).min)
NS_MAX = np.int64(np.iinfo(np.int64).max)

_EPOCH = None


def _datetime_to_ns(dt) -> np.int64:
    """Exact integer nanoseconds since epoch, clamped to int64.

    ``int(dt.timestamp() * 1e9)`` both overflows for far-future dates (year
    9999 'never expires' values are valid RFC3339) and mis-rounds ~97% of
    microsecond fractions through the float round-trip; integer timedelta
    arithmetic does neither.
    """
    global _EPOCH
    if _EPOCH is None:
        from datetime import datetime, timezone

        _EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
    delta = dt - _EPOCH
    ns = (delta.days * 86_400 + delta.seconds) * 10**9 + delta.microseconds * 1000
    return np.int64(max(int(NS_MIN), min(int(NS_MAX), ns)))


@dataclass
class OverrideSchedule:
    """Padded [T,O] override schedule + [T]/[T,R] spec threshold tensors.
    Field names and order match the JAX package's ``OverrideSchedule``."""

    ov_valid: torch.Tensor  # bool[T,O] — exists ∧ parses
    ov_begin: torch.Tensor  # int64[T,O] ns since epoch (NS_MIN if open)
    ov_end: torch.Tensor  # int64[T,O] ns (NS_MAX if open)
    ov_cnt: torch.Tensor  # int64[T,O]
    ov_cnt_present: torch.Tensor  # bool[T,O]
    ov_req: torch.Tensor  # int64[T,O,R]
    ov_req_present: torch.Tensor  # bool[T,O,R]
    spec_cnt: torch.Tensor  # int64[T]
    spec_cnt_present: torch.Tensor  # bool[T]
    spec_req: torch.Tensor  # int64[T,R]
    spec_req_present: torch.Tensor  # bool[T,R]


def encode_override_schedule(
    specs: Sequence[Optional[ThrottleSpecBase]],
    dims: DimRegistry,
    throttle_capacity: Optional[int] = None,
    override_capacity: Optional[int] = None,
    device=None,
) -> OverrideSchedule:
    """Encode throttle specs (``None`` for an unoccupied column) into an
    ``OverrideSchedule`` on ``device`` (``None`` → CUDA)."""
    dev = resolve_device(device)
    for spec in specs:
        if spec is None:  # unoccupied device column (padded capacity)
            continue
        for name in (spec.threshold.resource_requests or {}):
            dims.index_of(name)
        for o in spec.temporary_threshold_overrides:
            for name in (o.threshold.resource_requests or {}):
                dims.index_of(name)

    T = throttle_capacity if throttle_capacity is not None else max(len(specs), 1)
    max_overrides = max(
        (len(s.temporary_threshold_overrides) for s in specs if s is not None),
        default=0,
    )
    O = override_capacity if override_capacity is not None else max(max_overrides, 1)
    if max_overrides > O:
        raise ValueError(
            f"override_capacity={O} cannot hold {max_overrides} overrides; "
            "grow the capacity and re-encode (silent truncation would drop "
            "active overrides)"
        )
    R = dims.capacity

    ov_valid = np.zeros((T, O), dtype=bool)
    ov_begin = np.full((T, O), NS_MIN, dtype=np.int64)
    ov_end = np.full((T, O), NS_MAX, dtype=np.int64)
    ov_cnt = np.zeros((T, O), dtype=np.int64)
    ov_cnt_present = np.zeros((T, O), dtype=bool)
    ov_req = np.zeros((T, O, R), dtype=np.int64)
    ov_req_present = np.zeros((T, O, R), dtype=bool)
    spec_cnt = np.zeros(T, dtype=np.int64)
    spec_cnt_present = np.zeros(T, dtype=bool)
    spec_req = np.zeros((T, R), dtype=np.int64)
    spec_req_present = np.zeros((T, R), dtype=bool)

    for i, spec in enumerate(specs):
        if spec is None:
            continue
        if spec.threshold.resource_counts is not None:
            spec_cnt[i] = spec.threshold.resource_counts
            spec_cnt_present[i] = True
        for name, q in (spec.threshold.resource_requests or {}).items():
            j = dims.index_of(name)
            spec_req[i, j] = to_milli(q)
            spec_req_present[i, j] = True
        for k, o in enumerate(spec.temporary_threshold_overrides):
            try:
                begin_t = o.begin_time()
                end_t = o.end_time()
            except RFC3339ParseError:
                continue  # skipped, exactly like the Go loop (messages are host data)
            ov_valid[i, k] = True
            if begin_t is not None:
                ov_begin[i, k] = _datetime_to_ns(begin_t)
            if end_t is not None:
                ov_end[i, k] = _datetime_to_ns(end_t)
            if o.threshold.resource_counts is not None:
                ov_cnt[i, k] = o.threshold.resource_counts
                ov_cnt_present[i, k] = True
            for name, q in (o.threshold.resource_requests or {}).items():
                j = dims.index_of(name)
                ov_req[i, k, j] = to_milli(q)
                ov_req_present[i, k, j] = True

    host = dict(
        ov_valid=ov_valid, ov_begin=ov_begin, ov_end=ov_end, ov_cnt=ov_cnt,
        ov_cnt_present=ov_cnt_present, ov_req=ov_req, ov_req_present=ov_req_present,
        spec_cnt=spec_cnt, spec_cnt_present=spec_cnt_present, spec_req=spec_req,
        spec_req_present=spec_req_present,
    )
    return OverrideSchedule(**_tensors(host, dev))


def encode_class_thresholds(
    base_cnt: np.ndarray,  # int64[T] effective (override-resolved) thresholds
    base_cnt_present: np.ndarray,  # bool[T]
    base_req: np.ndarray,  # int64[T,R]
    base_req_present: np.ndarray,  # bool[T,R]
    accel_entries: Mapping[int, Sequence],  # col → (AccelClassThreshold, ...)
    classes: Sequence[str],
    dims: DimRegistry,
):
    """Per-(throttle, accel-class) effective-threshold tensor with
    first-wins merge (heterogeneity-aware admission, the gang check).

    Produces the ``[A, T]`` / ``[A, T, R]`` planes the gang kernel gathers
    per group: row 0 is the BASE effective threshold (exactly the staging
    planes the per-pod check kernel reads — already override-resolved), and
    row 1+a is the fleet seen through accelerator class ``classes[a]``:
    wherever a throttle column declares an ``accelClassThresholds`` entry
    for that class, the FIRST matching entry's threshold REPLACES the whole
    base row (counts and requests both — the same whole-replacement
    semantics as the temporary-override merge, api/types.py
    ``AccelClassThreshold``); columns without a matching entry keep the
    base row. ``accel_entries`` maps device column → the spec's entry
    tuple; only those sparse columns are touched, so the encode is
    O(A × accel-throttles), not O(A × T)."""
    T = base_cnt.shape[0]
    R = base_req.shape[1]
    A = 1 + len(classes)
    cnt = np.tile(base_cnt, (A, 1))
    cnt_p = np.tile(base_cnt_present, (A, 1))
    req = np.tile(base_req, (A, 1, 1))
    req_p = np.tile(base_req_present, (A, 1, 1))
    for a, cls in enumerate(classes, start=1):
        for col, entries in accel_entries.items():
            if col >= T:
                continue  # racing capacity growth: column not encoded yet
            entry = next((e for e in entries if e.accel_class == cls), None)
            if entry is None:
                continue
            thr = entry.threshold
            if thr.resource_counts is not None:
                cnt[a, col] = thr.resource_counts
                cnt_p[a, col] = True
            else:
                cnt[a, col] = 0
                cnt_p[a, col] = False
            req[a, col, :] = 0
            req_p[a, col, :] = False
            for name, q in (thr.resource_requests or {}).items():
                j = dims.index_of(name)
                if j >= R:
                    continue  # dim registered after the planes were sized
                req[a, col, j] = to_milli(q)
                req_p[a, col, j] = True
    return cnt, cnt_p, req, req_p


def _first_active(cand: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` at the first True slot of ``cand`` along dim 1: ``cand``
    bool[T,O(,R)], ``values`` int64 of the same shape. Where no slot is
    set the result is the last slot's value; callers mask it with
    ``cand.any(1)``."""
    O = cand.shape[1]
    order = torch.arange(O, device=cand.device).view((1, O) + (1,) * (cand.ndim - 2))
    first = torch.where(cand, order, O - 1).amin(dim=1, keepdim=True)
    return values.gather(1, first).squeeze(1)


def calculate_thresholds(sched: OverrideSchedule, now_ns: torch.Tensor):
    """Effective thresholds at ``now_ns`` (0-d int64 tensor on the
    schedule's device) for every throttle.

    Returns (thr_cnt int64[T], thr_cnt_present bool[T],
             thr_req int64[T,R], thr_req_present bool[T,R]).
    """
    # inclusive bounds: begin ≤ now ∧ now ≤ end (temporary_threshold_override.go:67-69)
    active = sched.ov_valid & (sched.ov_begin <= now_ns) & (now_ns <= sched.ov_end)  # [T,O]
    any_active = active.any(dim=1)  # [T]

    # counts: first active override that has a counts dim
    cnt_cand = active & sched.ov_cnt_present  # [T,O]
    cnt_any = cnt_cand.any(dim=1)
    cnt_val = _first_active(cnt_cand, sched.ov_cnt)

    thr_cnt_present = torch.where(any_active, cnt_any, sched.spec_cnt_present)
    thr_cnt = torch.where(any_active & cnt_any, cnt_val, sched.spec_cnt)
    thr_cnt = thr_cnt.masked_fill(~thr_cnt_present, 0)

    # requests: first active override that has each dim
    req_cand = active[:, :, None] & sched.ov_req_present  # [T,O,R]
    req_any = req_cand.any(dim=1)  # [T,R]
    req_val = _first_active(req_cand, sched.ov_req)  # [T,R]

    thr_req_present = torch.where(any_active[:, None], req_any, sched.spec_req_present)
    thr_req = torch.where(any_active[:, None] & req_any, req_val, sched.spec_req)
    thr_req = thr_req.masked_fill(~thr_req_present, 0)

    return thr_cnt, thr_cnt_present, thr_req, thr_req_present
