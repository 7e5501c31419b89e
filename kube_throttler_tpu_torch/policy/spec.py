"""Policy-as-data: per-accelerator-class value weights + preemption knobs.

The scheduling-policy layer Gavel ("Heterogeneity-Aware Cluster Scheduling
Policies for Deep Learning Workloads", PAPERS.md) argues for: which work a
cluster should protect is *data*, not code. A :class:`PolicySpec` carries

- **per-accel-class value weights** (the effective-throughput / value-
  function weights of "Value Function Based Performance Optimization of
  Deep Learning Workloads"): a class with a HIGHER weight is more valuable
  per occupied slot — its throttles' flips are promoted first through the
  workqueue's ``(-priority, seq)`` hi lane, and its pods are evicted LAST
  by victim selection (rank ascends by weight);
- **preemption knobs**: enable flag, per-cycle victim cap, per-group
  cooldown (the anti-thrash floor the preemption-storm scenario gates),
  and the priority gap a victim must sit below the preemptor by;
- **rank-aware placement** toggle ("Rank-Aware Resource Scheduling for
  Tightly-Coupled MPI Workloads"): topology-contiguity scoring in the
  scheduler's tentative gang placement.

Hot swap rides the SAME machinery as temporaryThresholdOverrides
(api/types.py): each spec has RFC3339 ``begin``/``end`` activation
boundaries (empty = open-ended, both inclusive — literally
``TemporaryThresholdOverride.is_active``), the FIRST active spec wins
whole-replacement (no per-field merge ambiguity), and
:meth:`PolicyEngine.set_specs` swaps the whole list atomically at runtime.
With no spec active (or none configured) the engine serves the built-in
default: weights 1.0, preemption off — every consumer degrades to the
pre-policy behavior byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..api.types import TemporaryThresholdOverride
from ..utils.clock import Clock, RealClock
from ..utils.lockorder import guard_attrs, make_lock

# hi-lane promotion priorities are ints; weights are small floats — one
# fixed scale maps them losslessly for any weight expressed in hundredths
PROMOTION_PRIORITY_SCALE = 100


@dataclass(frozen=True)
class ClassWeight:
    """One accelerator class's value weight (first-wins within a spec,
    like the override merge). ``weight`` is relative: only order matters
    to victim ranking; magnitude feeds the flip promotion priority."""

    accel_class: str = ""
    weight: float = 1.0


@dataclass(frozen=True)
class PolicySpec:
    """One policy window. ``begin``/``end`` are RFC3339 activation
    boundaries with temporaryThresholdOverrides semantics (empty =
    open-ended; active iff begin ≤ now ∧ (end == "" ∨ now ≤ end))."""

    name: str = "default"
    begin: str = ""
    end: str = ""
    class_weights: Tuple[ClassWeight, ...] = ()
    default_weight: float = 1.0
    preemption_enabled: bool = False
    max_victims_per_cycle: int = 32
    preempt_cooldown_s: float = 0.0
    min_priority_gap: int = 1
    rank_aware_placement: bool = True

    def is_active(self, now: datetime) -> bool:
        """The exact temporaryThresholdOverrides window predicate —
        delegated, not reimplemented, so the two mechanisms can never
        drift (both boundaries inclusive, RFC3339ParseError on bad
        input)."""
        return TemporaryThresholdOverride(begin=self.begin, end=self.end).is_active(
            now
        )

    def weight_for(self, accel_class: Optional[str]) -> float:
        """First class_weights entry naming ``accel_class`` (first wins,
        like the override merge), else the default weight. Pods with no
        class use the default too."""
        if accel_class:
            for entry in self.class_weights:
                if entry.accel_class == accel_class:
                    return float(entry.weight)
        return float(self.default_weight)

    def promotion_priority(self, accel_classes: Iterable[str]) -> int:
        """Hi-lane priority for a throttle declaring ``accel_classes``:
        the max class weight above the default, scaled to an int. A
        throttle with no class entries (or classes the policy does not
        weight above default) promotes at 0 — the original FIFO lane."""
        best = 0.0
        for cls in accel_classes:
            w = self.weight_for(cls) - float(self.default_weight)
            if w > best:
                best = w
        return int(round(best * PROMOTION_PRIORITY_SCALE))


DEFAULT_POLICY = PolicySpec()


@guard_attrs
class PolicyEngine:
    """The hot-swappable policy holder every consumer reads through.

    Consumers (victim selection, the controllers' flip promotion, the
    scheduler's placement scoring) call :meth:`active` per decision — the
    spec list is tiny and the is_active probes are string-empty checks in
    the common case, so there is no caching layer to invalidate on a
    swap. ``generation`` bumps per :meth:`set_specs` for observability."""

    GUARDED_BY = {"_specs": "self._lock", "generation": "self._lock"}

    def __init__(
        self,
        specs: Sequence[PolicySpec] = (),
        clock: Optional[Clock] = None,
    ):
        self._lock = make_lock("policy.engine")
        self._specs: Tuple[PolicySpec, ...] = tuple(specs)
        self._clock = clock or RealClock()
        self.generation = 0

    def set_specs(self, specs: Sequence[PolicySpec]) -> int:
        """Atomically replace the whole spec list (the hot swap). Returns
        the new generation."""
        with self._lock:
            self._specs = tuple(specs)
            self.generation += 1
            return self.generation

    def specs(self) -> Tuple[PolicySpec, ...]:
        with self._lock:
            return self._specs

    def current_generation(self) -> int:
        """``generation`` read under the engine's lock: the pod-event path
        reads it on the thread that applies events while ``set_specs``
        writes it on another."""
        with self._lock:
            return self.generation

    def active(self, now: Optional[datetime] = None) -> PolicySpec:
        """The FIRST active spec (first-wins whole-replacement, the
        override discipline), else the built-in default. A spec whose
        boundary fails to parse is skipped — a config typo must not
        disable policy resolution for the specs after it."""
        now = now or self._clock.now()
        for spec in self.specs():
            try:
                if spec.is_active(now):
                    return spec
            except ValueError:
                continue
        return DEFAULT_POLICY


# -- config decoding (plugin args / hot-swap payloads) -----------------------


def policy_spec_from_dict(d: Dict) -> PolicySpec:
    """Decode one camelCase policy entry (the plugin-args / hot-swap wire
    form). Unknown keys are rejected — a policy written by a newer schema
    must fail loudly, not silently drop a knob."""
    d = dict(d)
    weights = []
    for w in d.pop("classWeights", ()) or ():
        w = dict(w)
        cls = str(w.pop("accelClass", "") or "")
        weight = float(w.pop("weight", 1.0))
        if w:
            raise ValueError(f"unknown classWeights keys: {sorted(w)}")
        if not cls:
            raise ValueError("classWeights entries need a non-empty accelClass")
        if weight < 0:
            raise ValueError(f"classWeights weight must be >= 0: {weight!r}")
        weights.append(ClassWeight(accel_class=cls, weight=weight))
    spec = PolicySpec(
        name=str(d.pop("name", "default") or "default"),
        begin=str(d.pop("begin", "") or ""),
        end=str(d.pop("end", "") or ""),
        class_weights=tuple(weights),
        default_weight=float(d.pop("defaultWeight", 1.0)),
        preemption_enabled=bool(d.pop("preemptionEnabled", False)),
        max_victims_per_cycle=int(d.pop("maxVictimsPerCycle", 32)),
        preempt_cooldown_s=float(d.pop("preemptCooldownSeconds", 0.0)),
        min_priority_gap=int(d.pop("minPriorityGap", 1)),
        rank_aware_placement=bool(d.pop("rankAwarePlacement", True)),
    )
    if d:
        raise ValueError(f"unknown policy keys: {sorted(d)}")
    if spec.max_victims_per_cycle <= 0:
        raise ValueError(
            f"maxVictimsPerCycle must be positive: {spec.max_victims_per_cycle!r}"
        )
    if spec.preempt_cooldown_s < 0:
        raise ValueError(
            f"preemptCooldownSeconds must be >= 0: {spec.preempt_cooldown_s!r}"
        )
    if spec.min_priority_gap < 0:
        raise ValueError(f"minPriorityGap must be >= 0: {spec.min_priority_gap!r}")
    if spec.default_weight < 0:
        raise ValueError(f"defaultWeight must be >= 0: {spec.default_weight!r}")
    return spec


def policy_specs_from_config(raw) -> Tuple[PolicySpec, ...]:
    """Decode the plugin-args ``policies`` list (or a single dict)."""
    if raw is None:
        return ()
    if isinstance(raw, dict):
        raw = [raw]
    return tuple(policy_spec_from_dict(d) for d in raw)
