"""Victim selection: deficits, eviction units, and the sequential oracle.

Semantics are DERIVED from the admission inequality, not invented. A gang
that ``pre_filter_gang`` rejected for capacity is blocked on every
(throttle, dimension) where

    used + reserved + group_total > threshold          (the overflow form)

so the capacity that must be freed — the **deficit** — is exactly
``used + reserved + group_total - threshold`` on each such pair
(:func:`compute_gang_deficits`; thresholds are the accel-class-resolved
effective thresholds, the same resolution order as the gang kernel). A
pod's eviction frees its contribution to ``used`` on every throttle it
matches, so victim selection is: walk candidates in rank order and keep
the ones that still reduce an unmet deficit, until every deficit is met.

**Rank order** (policy weight asc, priority asc, age desc): cheapest work
first — lowest value-weight class, then lowest priority, then the OLDEST
among ties (it has had its run; a deterministic tie-break on the unit key
closes the order totally). :func:`rank_eviction_units` implements it.

**Eviction units**: a victim that belongs to a gang drags its WHOLE gang —
admitting half-evicted gangs would recreate exactly the stranded-capacity
problem gang admission exists to prevent — so candidates are grouped into
units (single pod, or every running member of one gang) and selection
operates on units.

:func:`sequential_victim_select` is the per-candidate ORACLE: a plain
Python greedy walk over the flattened deficit vector. The batched kernel
(ops/victim_select.py) computes the SAME walk in one single-block CUDA
launch over the ranked contribution matrix; the seeded equivalence sweep
and the hypothesis twin (tests/test_torch_victim_select.py) pin kernel ≡
oracle on both the verdict and the selected set.

All quantities are integer milli-units (``_milli_ceil`` — conservative
ceiling for sub-milli fractions, identical on both paths) so kernel and
oracle do exact integer arithmetic on identical arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.pod import Pod, accel_class_of
from ..api.types import (
    ResourceAmount,
    effective_threshold,
    resource_amount_of_pod,
)

# deficit / contribution key: (kind, throttle_key, dim) where dim is the
# reserved name "pod" (count) or a resource name (milli-units)
DimKey = Tuple[str, str, str]
COUNT_DIM = "pod"


def _milli_ceil(value: Fraction) -> int:
    """Ceiling milli-units of a Fraction — exact for milli-precision
    quantities (the normal case), conservatively rounded UP otherwise so
    a freed sub-milli sliver is never counted as covering a deficit it
    does not."""
    value = Fraction(value)
    return -((-value.numerator * 1000) // value.denominator)


def _amount_milli(amount: ResourceAmount) -> Tuple[int, Dict[str, int]]:
    counts = amount.resource_counts or 0
    reqs = {
        rn: _milli_ceil(q) for rn, q in (amount.resource_requests or {}).items()
    }
    return counts, reqs


def compute_gang_deficits(
    members: Sequence[Pod],
    kind_controllers: Sequence[Tuple[str, object]],
) -> Optional[Dict[DimKey, int]]:
    """Per-(kind, throttle, dim) capacity that must be freed before the
    group fits: ``used + reserved + group_total - threshold`` wherever
    positive, over every throttle any member matches. Thresholds are
    accel-class-resolved (the group's class, like the gang kernel);
    request dims count only when some matched member requests them
    non-zero (the ``is_throttled_for`` gate). Returns None when the group
    is infeasible regardless of eviction — some member ALONE exceeds a
    threshold (step 1), which no victim set can fix. An empty dict means
    nothing needs freeing (the block was not capacity-shaped)."""
    accel = next((c for c in map(accel_class_of, members) if c), None)
    deficits: Dict[DimKey, int] = {}
    for kind, ctr in kind_controllers:
        # union of matched throttles with per-throttle matched members
        matched: Dict[str, Tuple[object, List[Pod]]] = {}
        for pod in members:
            for thr in ctr.affected_throttles(pod):
                entry = matched.get(thr.key)
                if entry is None:
                    matched[thr.key] = (thr, [pod])
                else:
                    entry[1].append(pod)
        for tkey, (thr, tpods) in matched.items():
            threshold = thr.spec.accel_threshold_for(accel)
            if threshold is None:
                threshold = effective_threshold(thr.spec.threshold, thr.status)
            thr_cnt, thr_req = (
                threshold.resource_counts,
                threshold.resource_requests or {},
            )
            # step-1 screen: a member alone over the threshold is
            # un-preemptable — nothing freed can admit it
            for pod in tpods:
                pa = resource_amount_of_pod(pod)
                if threshold.is_throttled(pa, False).is_throttled_for(pod):
                    return None
            used_cnt, used_req = _amount_milli(thr.status.used)
            res_cnt, res_req = _amount_milli(
                ctr.cache.reserved_resource_amount(tkey)[0]
            )
            g_cnt = len(tpods)
            g_req: Dict[str, int] = {}
            for pod in tpods:
                _, preq = _amount_milli(resource_amount_of_pod(pod))
                for rn, m in preq.items():
                    g_req[rn] = g_req.get(rn, 0) + m
            if thr_cnt is not None:
                need = used_cnt + res_cnt + g_cnt - int(thr_cnt)
                if need > 0:
                    deficits[(kind, tkey, COUNT_DIM)] = need
            for rn, tq in thr_req.items():
                g_rn = g_req.get(rn, 0)
                if g_rn <= 0:
                    continue  # no member requests it non-zero: never blocks
                need = (
                    used_req.get(rn, 0) + res_req.get(rn, 0) + g_rn
                    - _milli_ceil(tq)
                )
                if need > 0:
                    deficits[(kind, tkey, rn)] = need
    return deficits


@dataclass
class EvictionUnit:
    """One atomically-evictable candidate: a single running pod, or every
    running member of one gang (whole gangs evict together — the
    all-or-nothing contract runs both ways). ``contrib`` maps
    (kind, throttle_key) to the unit's freed amounts there."""

    unit_key: str
    pods: Tuple[Pod, ...]
    priority: int = 0
    weight: float = 1.0
    age_s: float = float("inf")  # unknown admission time ranks oldest
    gang_key: Optional[str] = None
    contrib: Dict[Tuple[str, str], Tuple[int, Dict[str, int]]] = field(
        default_factory=dict
    )

    def add_pod_contrib(self, kind: str, throttle_key: str, pod: Pod) -> None:
        cnt, req = _amount_milli(resource_amount_of_pod(pod))
        cur_cnt, cur_req = self.contrib.get((kind, throttle_key), (0, {}))
        merged = dict(cur_req)
        for rn, m in req.items():
            merged[rn] = merged.get(rn, 0) + m
        self.contrib[(kind, throttle_key)] = (cur_cnt + cnt, merged)


def rank_eviction_units(units: Sequence[EvictionUnit]) -> List[EvictionUnit]:
    """(policy weight asc, priority asc, age desc), unit-key tie-break —
    the total, deterministic victim order both selection paths walk."""
    return sorted(units, key=lambda u: (u.weight, u.priority, -u.age_s, u.unit_key))


def build_selection_problem(
    deficits: Dict[DimKey, int],
    units: Sequence[EvictionUnit],
) -> Tuple[List[DimKey], np.ndarray, np.ndarray]:
    """Flatten deficits + ranked-unit contributions into the arrays BOTH
    selection paths consume: ``(dims, deficit int64[M], contrib
    int64[N, M])``. Dims are sorted for determinism; ``units`` must
    already be in rank order (the row order IS the selection order)."""
    dims = sorted(deficits)
    deficit = np.array([deficits[d] for d in dims], dtype=np.int64)
    contrib = np.zeros((len(units), len(dims)), dtype=np.int64)
    dim_index = {d: j for j, d in enumerate(dims)}
    for i, unit in enumerate(units):
        for (kind, tkey), (cnt, req) in unit.contrib.items():
            j = dim_index.get((kind, tkey, COUNT_DIM))
            if j is not None:
                contrib[i, j] += cnt
            for rn, m in req.items():
                j = dim_index.get((kind, tkey, rn))
                if j is not None:
                    contrib[i, j] += m
    return dims, deficit, contrib


def sequential_victim_select(
    deficit: np.ndarray,
    contrib: np.ndarray,
    max_victims: int = 0,
) -> Tuple[bool, List[int], np.ndarray]:
    """The per-candidate ORACLE the batched kernel must equal: walk the
    ranked rows in order; select a row iff it contributes to some still-
    positive deficit (and the victim cap is not exhausted); subtract its
    whole contribution. Returns ``(ok, selected row indices, remaining)``
    — ``ok`` iff every deficit reached ≤ 0. ``max_victims`` ≤ 0 means
    uncapped. Pure; never mutates its inputs."""
    remaining = np.array(deficit, dtype=np.int64, copy=True)
    selected: List[int] = []
    for i in range(contrib.shape[0]):
        if np.all(remaining <= 0):
            break
        if max_victims > 0 and len(selected) >= max_victims:
            break
        row = contrib[i]
        if np.any((row > 0) & (remaining > 0)):
            remaining -= row
            selected.append(i)
    return bool(np.all(remaining <= 0)), selected, remaining
