"""Throttle / ClusterThrottle API types and the pure decision core (oracle).

Mirrors reference pkg/apis/schedule/v1alpha1/:

- ``ResourceAmount`` + ``is_throttled``      — resource_amount.go:28-159
- ``IsResourceAmountThrottled.is_throttled_for`` — resource_amount.go:46-65
- ``TemporaryThresholdOverride``             — temporary_threshold_override.go:26-70
- ``calculate_threshold`` (first-wins merge) — throttle_types.go:65-106
- ``next_override_happens_in``               — throttle_types.go:37-63
- 4-state ``check_throttled_for``            — throttle_types.go:128-153 and
  clusterthrottle_types.go:30-55 (which differ ONLY in step-3's onEqual:
  Throttle hardcodes True, ClusterThrottle passes the caller's flag)
- selectors (OR of terms; term = AND of label selectors)
                                             — throttle_selector.go:26-54,
                                               clusterthrottle_selector.go:26-87

Deliberate divergences from the reference (SURVEY.md §2.3 quirk decisions):
- ``ResourceAmount.add/sub`` are pure (return new objects) instead of
  mutating shared maps; all reference call sites build fresh accumulators so
  observable behavior is identical.
- The ``terminatedPods = append(nonterminatedPods, ...)`` slice bug
  (throttle_controller.go:241) is NOT reproduced; the controller layer
  handles terminated pods correctly for both kinds.
- Typos that are API surface (``selecterTerms`` JSON field, ``kubeconifg``)
  are accepted on input for manifest compatibility (see serialization).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from functools import cached_property
from datetime import datetime, timedelta, timezone
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resourcelist as rl
from ..quantity import parse_quantity
from .pod import Namespace, Pod

# ---------------------------------------------------------------------------
# ResourceAmount
# ---------------------------------------------------------------------------

ZERO = Fraction(0)


@dataclass(frozen=True)
class ResourceAmount:
    """{resourceCounts: {pod: int}|nil, resourceRequests: ResourceList|nil}.

    ``None`` mirrors Go's nil: a nil counts/requests member means the
    dimension family is *absent*, which is semantically different from zero
    (absent dimensions are never evaluated — resource_amount.go:143,151-155).
    """

    resource_counts: Optional[int] = None  # pod count; None == nil *ResourceCounts
    resource_requests: Optional[Dict[str, Fraction]] = None

    @staticmethod
    def of(
        pod: Optional[int] = None,
        requests: Optional[Dict[str, object]] = None,
    ) -> "ResourceAmount":
        return ResourceAmount(
            resource_counts=pod,
            resource_requests=(
                {k: parse_quantity(v) for k, v in requests.items()}
                if requests is not None
                else None
            ),
        )

    def add(self, b: "ResourceAmount") -> "ResourceAmount":
        """resource_amount.go:91-110 (pure variant)."""
        requests = dict(self.resource_requests or {})
        if self.resource_counts is None:
            counts = b.resource_counts
        elif b.resource_counts is not None:
            counts = self.resource_counts + b.resource_counts
        else:
            counts = self.resource_counts
        rl.add(requests, b.resource_requests or {})
        return ResourceAmount(resource_counts=counts, resource_requests=requests)

    def sub(self, b: "ResourceAmount") -> "ResourceAmount":
        """resource_amount.go:112-125 — pod count clamps at 0, requests may go
        negative (SURVEY.md §2.3 quirk 4, preserved)."""
        requests = dict(self.resource_requests or {})
        counts = self.resource_counts
        if self.resource_counts is not None and b.resource_counts is not None:
            counts = max(0, self.resource_counts - b.resource_counts)
        rl.sub(requests, b.resource_requests or {})
        return ResourceAmount(resource_counts=counts, resource_requests=requests)

    def is_throttled(
        self, used: "ResourceAmount", is_throttled_on_equal: bool
    ) -> "IsResourceAmountThrottled":
        """self is the *threshold* (resource_amount.go:127-159).

        Only dimensions present in the threshold are evaluated; threshold
        dimensions absent from ``used`` evaluate to not-throttled.
        """

        def hit(u: Fraction, t: Fraction) -> bool:
            return u >= t if is_throttled_on_equal else u > t

        counts_throttled = False
        if self.resource_counts is not None and used.resource_counts is not None:
            counts_throttled = hit(used.resource_counts, self.resource_counts)

        requests_throttled: Optional[Dict[str, bool]] = None
        if self.resource_requests is not None:
            for rn, qt in self.resource_requests.items():
                if requests_throttled is None:
                    requests_throttled = {}
                used_reqs = used.resource_requests or {}
                if rn in used_reqs:
                    requests_throttled[rn] = hit(used_reqs[rn], qt)
                else:
                    requests_throttled[rn] = False
            # NOTE: Go only allocates the map inside the loop, so an *empty*
            # threshold request map yields a nil flag map — preserved here.

        return IsResourceAmountThrottled(
            resource_counts_pod=counts_throttled,
            resource_requests=requests_throttled,
        )

    def to_dict(self) -> Dict[str, object]:
        from ..quantity import format_quantity

        out: Dict[str, object] = {}
        if self.resource_counts is not None:
            out["resourceCounts"] = {"pod": self.resource_counts}
        if self.resource_requests is not None:
            out["resourceRequests"] = {
                k: format_quantity(v) for k, v in sorted(self.resource_requests.items())
            }
        return out


@dataclass(frozen=True)
class IsResourceAmountThrottled:
    """Per-dimension throttled flags (resource_amount.go:39-44)."""

    resource_counts_pod: bool = False
    resource_requests: Optional[Dict[str, bool]] = None

    def is_throttled_for(self, pod: Pod) -> bool:
        """resource_amount.go:46-65: the pod-count flag always blocks; a
        request flag blocks only if the pod requests that resource non-zero."""
        if self.resource_counts_pod:
            return True
        pod_amount = resource_amount_of_pod(pod)
        flags = self.resource_requests or {}
        for rn, rq in (pod_amount.resource_requests or {}).items():
            if rq == 0:
                continue
            if flags.get(rn, False):
                return True
        return False

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {"resourceCounts": {"pod": self.resource_counts_pod}}
        if self.resource_requests is not None:
            out["resourceRequests"] = dict(sorted(self.resource_requests.items()))
        return out


def resource_amount_of_pod(pod: Pod) -> ResourceAmount:
    """resource_amount.go:71-76."""
    return ResourceAmount(
        resource_counts=1,
        resource_requests=rl.pod_request_resource_list(pod),
    )


# ---------------------------------------------------------------------------
# Temporary threshold overrides
# ---------------------------------------------------------------------------

_RFC3339_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[Tt](\d{2}):(\d{2}):(\d{2})(\.\d+)?([Zz]|[+-]\d{2}:\d{2})$"
)


class RFC3339ParseError(ValueError):
    pass


def parse_rfc3339(s: str) -> datetime:
    """Strict RFC3339 (Go's ``time.Parse(time.RFC3339, ...)`` layout)."""
    m = _RFC3339_RE.match(s)
    if m is None:
        raise RFC3339ParseError(
            f'parsing time "{s}" as RFC3339: cannot parse {s!r}'
        )
    year, month, day, hour, minute, sec = (int(m.group(i)) for i in range(1, 7))
    frac = m.group(7)
    # exact decimal digits, not float round-trip (".000249" must be 249 µs)
    micro = int(frac[1:7].ljust(6, "0")) if frac else 0
    off = m.group(8)
    try:
        if off in ("Z", "z"):
            tz = timezone.utc
        else:
            sign = 1 if off[0] == "+" else -1
            tz = timezone(sign * timedelta(hours=int(off[1:3]), minutes=int(off[4:6])))
        return datetime(year, month, day, hour, minute, sec, micro, tzinfo=tz)
    except ValueError as e:
        raise RFC3339ParseError(f'parsing time "{s}": {e}') from e


@dataclass(frozen=True)
class TemporaryThresholdOverride:
    """temporary_threshold_override.go:26-70. begin/end are RFC3339 strings;
    empty string means open-ended (zero time). Active iff
    begin ≤ now ∧ (end == "" ∨ now ≤ end) — both boundaries inclusive."""

    begin: str = ""
    end: str = ""
    threshold: ResourceAmount = field(default_factory=ResourceAmount)

    def begin_time(self) -> Optional[datetime]:
        """None mirrors the zero time. Raises RFC3339ParseError on bad input."""
        if self.begin == "":
            return None
        try:
            return parse_rfc3339(self.begin)
        except RFC3339ParseError as e:
            raise RFC3339ParseError(f"Failed to parse Begin: {e}") from e

    def end_time(self) -> Optional[datetime]:
        if self.end == "":
            return None
        try:
            return parse_rfc3339(self.end)
        except RFC3339ParseError as e:
            raise RFC3339ParseError(f"Failed to parse End: {e}") from e

    def is_active(self, now: datetime) -> bool:
        """temporary_threshold_override.go:57-70; raises on parse error."""
        begin_t = self.begin_time()
        end_t = self.end_time()
        begin_ok = begin_t is None or begin_t <= now
        end_ok = end_t is None or now <= end_t
        return begin_ok and end_ok


@dataclass(frozen=True)
class CalculatedThreshold:
    """calculated_threshold.go:24-30."""

    threshold: ResourceAmount = field(default_factory=ResourceAmount)
    calculated_at: Optional[datetime] = None  # None mirrors the zero time
    messages: Tuple[str, ...] = ()


@dataclass(frozen=True)
class AccelClassThreshold:
    """Per-accelerator-class effective threshold (heterogeneity-aware
    admission, docs/gang_admission.md).

    A mixed fleet's throttle capacity depends on which accelerator class a
    pod lands on: the same ``cpu: 10`` budget may admit 40 v5e ranks but
    only 8 v5p ranks. A spec may declare a list of these; for a pod whose
    ``accel-class`` annotation equals ``accel_class``, the FIRST matching
    entry's threshold REPLACES the throttle's effective (override-resolved)
    threshold entirely — the same first-wins / whole-replacement semantics
    as temporaryThresholdOverrides, so the two mechanisms compose without a
    per-dimension merge ambiguity. Pods without a class (or with a class no
    entry names) use the base effective threshold.

    The persisted ``status.throttled`` flags stay class-agnostic (they are
    derived from the base threshold at reconcile); class resolution applies
    to the live admission inequality (steps 1/3/4), not to step 2."""

    accel_class: str = ""
    threshold: ResourceAmount = field(default_factory=ResourceAmount)


# ---------------------------------------------------------------------------
# Selectors
# ---------------------------------------------------------------------------


class SelectorError(ValueError):
    """Invalid label selector (mirrors LabelSelectorAsSelector errors)."""


_VALID_OPS = ("In", "NotIn", "Exists", "DoesNotExist")


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: AND of matchLabels + matchExpressions.

    An empty (but present) selector matches everything — the reference's
    selector *terms* hold LabelSelector by value, so a term with no
    constraints matches every pod (SURVEY §2: "empty term matches
    everything").
    """

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: Tuple[LabelSelectorRequirement, ...] = ()

    def validate(self) -> None:
        """Mirror LabelSelectorAsSelector: the whole selector is validated
        before any label is compared, so an invalid selector errors even when
        matchLabels alone would already fail the match."""
        for req in self.match_expressions:
            if req.operator not in _VALID_OPS:
                raise SelectorError(f"{req.operator!r} is not a valid label selector operator")
            if req.operator in ("In", "NotIn") and not req.values:
                raise SelectorError("values must be specified when `operator` is 'In' or 'NotIn'")
            if req.operator in ("Exists", "DoesNotExist") and req.values:
                raise SelectorError("values must not be specified when `operator` is 'Exists' or 'DoesNotExist'")

    def matches(self, labels: Dict[str, str]) -> bool:
        self.validate()
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            present = req.key in labels
            if req.operator == "In":
                if not present or labels[req.key] not in req.values:
                    return False
            elif req.operator == "NotIn":
                if present and labels[req.key] in req.values:
                    return False
            elif req.operator == "Exists":
                if not present:
                    return False
            else:  # DoesNotExist
                if present:
                    return False
        return True


@dataclass(frozen=True)
class ThrottleSelectorTerm:
    """throttle_selector.go:44-54."""

    pod_selector: LabelSelector = field(default_factory=LabelSelector)

    def matches_to_pod(self, pod: Pod) -> bool:
        return self.pod_selector.matches(pod.labels)


@dataclass(frozen=True)
class ThrottleSelector:
    """throttle_selector.go:26-42: OR of terms; no terms → matches nothing."""

    selector_terms: Tuple[ThrottleSelectorTerm, ...] = ()

    def matches_to_pod(self, pod: Pod) -> bool:
        for term in self.selector_terms:
            if term.matches_to_pod(pod):
                return True
        return False


@dataclass(frozen=True)
class ClusterThrottleSelectorTerm:
    """clusterthrottle_selector.go:58-87: namespaceSelector ∧ podSelector.

    A namespace-selector *error* is swallowed as no-match (Go returns
    ``false, nil`` at clusterthrottle_selector.go:63-68 — preserved)."""

    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    namespace_selector: LabelSelector = field(default_factory=LabelSelector)

    def matches_to_namespace(self, ns: Namespace) -> bool:
        try:
            return self.namespace_selector.matches(ns.labels)
        except SelectorError:
            return False

    def matches_to_pod(self, pod: Pod, ns: Namespace) -> bool:
        if not self.matches_to_namespace(ns):
            return False
        return self.pod_selector.matches(pod.labels)


@dataclass(frozen=True)
class ClusterThrottleSelector:
    """clusterthrottle_selector.go:26-56."""

    selector_terms: Tuple[ClusterThrottleSelectorTerm, ...] = ()

    def matches_to_namespace(self, ns: Namespace) -> bool:
        for term in self.selector_terms:
            if term.matches_to_namespace(ns):
                return True
        return False

    def matches_to_pod(self, pod: Pod, ns: Namespace) -> bool:
        for term in self.selector_terms:
            if term.matches_to_pod(pod, ns):
                return True
        return False


# ---------------------------------------------------------------------------
# Specs, statuses, CRD objects
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ThrottleSpecBase:
    """throttle_types.go:28-35 (+ the heterogeneity extension
    ``accelClassThresholds`` — see AccelClassThreshold)."""

    throttler_name: str = ""
    threshold: ResourceAmount = field(default_factory=ResourceAmount)
    temporary_threshold_overrides: Tuple[TemporaryThresholdOverride, ...] = ()
    accel_class_thresholds: Tuple[AccelClassThreshold, ...] = ()

    def accel_threshold_for(self, accel_class: Optional[str]) -> Optional[ResourceAmount]:
        """First accelClassThresholds entry naming ``accel_class`` (first
        wins, like the override merge), or None."""
        if not accel_class:
            return None
        for entry in self.accel_class_thresholds:
            if entry.accel_class == accel_class:
                return entry.threshold
        return None

    def next_override_happens_in(self, now: datetime) -> Optional[timedelta]:
        """throttle_types.go:37-63: soonest future begin/end boundary."""
        next_after: Optional[timedelta] = None

        def update(d: timedelta) -> None:
            nonlocal next_after
            if next_after is None or next_after > d:
                next_after = d

        for o in self.temporary_threshold_overrides:
            try:
                begin_t = o.begin_time()
            except RFC3339ParseError:
                continue
            if begin_t is not None and begin_t > now:
                update(begin_t - now)
            try:
                end_t = o.end_time()
            except RFC3339ParseError:
                continue
            if end_t is not None and end_t > now:
                update(end_t - now)
        return next_after

    def calculate_threshold(self, now: datetime) -> CalculatedThreshold:
        """throttle_types.go:65-106.

        First-wins merge per dimension across active overrides; if ANY
        override is active the merged result REPLACES the entire spec
        threshold (dimensions absent from the merge become absent, i.e.
        unchecked — throttle_types.go:96-98)."""
        active_found = False
        override_counts: Optional[int] = None
        override_requests: Dict[str, Fraction] = {}
        messages: List[str] = []
        for i, o in enumerate(self.temporary_threshold_overrides):
            try:
                is_active = o.is_active(now)
            except RFC3339ParseError as e:
                messages.append(f"index {i}: {e}")
                continue
            if is_active:
                active_found = True
                if override_counts is None and o.threshold.resource_counts is not None:
                    override_counts = o.threshold.resource_counts
                for rn, rq in (o.threshold.resource_requests or {}).items():
                    if rn not in override_requests:
                        override_requests[rn] = rq

        threshold = self.threshold
        if active_found:
            threshold = ResourceAmount(
                resource_counts=override_counts, resource_requests=override_requests
            )
        return CalculatedThreshold(
            threshold=threshold, calculated_at=now, messages=tuple(messages)
        )


@dataclass(frozen=True)
class ThrottleSpec(ThrottleSpecBase):
    selector: ThrottleSelector = field(default_factory=ThrottleSelector)


@dataclass(frozen=True)
class ClusterThrottleSpec(ThrottleSpecBase):
    selector: ClusterThrottleSelector = field(default_factory=ClusterThrottleSelector)


@dataclass(frozen=True)
class ThrottleStatus:
    """throttle_types.go:113-117 (shared by both kinds)."""

    calculated_threshold: CalculatedThreshold = field(default_factory=CalculatedThreshold)
    throttled: IsResourceAmountThrottled = field(default_factory=IsResourceAmountThrottled)
    used: ResourceAmount = field(default_factory=ResourceAmount)


class CheckThrottleStatus:
    """throttle_types.go:119-126 — exact reference status strings."""

    NOT_THROTTLED = "not-throttled"
    ACTIVE = "active"
    INSUFFICIENT = "insufficient"
    POD_REQUESTS_EXCEEDS_THRESHOLD = "pod-requests-exceeds-threshold"


def effective_threshold(spec_threshold: ResourceAmount, status: ThrottleStatus) -> ResourceAmount:
    """The threshold a check actually uses: status.calculatedThreshold once a
    reconcile has stamped calculatedAt, else spec.threshold
    (throttle_types.go:129-132). Single source of truth — the host oracle,
    the standalone tensor encoder, and the live device mirror all call this."""
    if status.calculated_threshold.calculated_at is not None:
        return status.calculated_threshold.threshold
    return spec_threshold


def _check_throttled_for(
    spec_threshold: ResourceAmount,
    status: ThrottleStatus,
    pod: Pod,
    reserved: ResourceAmount,
    is_throttled_on_equal: bool,
    step3_on_equal: bool,
    threshold_override: Optional[ResourceAmount] = None,
) -> str:
    """The ordered 4-state check (throttle_types.go:128-153).

    step3_on_equal is True for Throttle (hardcoded at throttle_types.go:143)
    and ``is_throttled_on_equal`` for ClusterThrottle
    (clusterthrottle_types.go:45) — the one asymmetry between the kinds.

    ``threshold_override`` (heterogeneity: a resolved per-accelerator-class
    threshold) replaces the effective threshold for steps 1/3/4; step 2's
    persisted flags stay class-agnostic by contract (AccelClassThreshold).
    """
    threshold = (
        threshold_override
        if threshold_override is not None
        else effective_threshold(spec_threshold, status)
    )

    pod_amount = resource_amount_of_pod(pod)

    # 1. the pod alone exceeds the threshold → it can never schedule
    if threshold.is_throttled(pod_amount, False).is_throttled_for(pod):
        return CheckThrottleStatus.POD_REQUESTS_EXCEEDS_THRESHOLD

    # 2. the persisted throttled flags already block this pod
    if status.throttled.is_throttled_for(pod):
        return CheckThrottleStatus.ACTIVE

    # 3. used + reserved saturates the threshold
    already_used = ResourceAmount().add(status.used).add(reserved)
    if threshold.is_throttled(already_used, step3_on_equal).is_throttled_for(pod):
        return CheckThrottleStatus.ACTIVE

    # 4. used + reserved + pod would overflow it
    used = ResourceAmount().add(status.used).add(pod_amount).add(reserved)
    if threshold.is_throttled(used, is_throttled_on_equal).is_throttled_for(pod):
        return CheckThrottleStatus.INSUFFICIENT

    return CheckThrottleStatus.NOT_THROTTLED


@dataclass(frozen=True)
class Throttle:
    """Namespaced CRD (throttle_types.go:163-169)."""

    name: str
    namespace: str = "default"
    uid: str = ""
    spec: ThrottleSpec = field(default_factory=ThrottleSpec)
    status: ThrottleStatus = field(default_factory=ThrottleStatus)

    @cached_property
    def key(self) -> str:
        # cached_property on a frozen dataclass: writes via the instance
        # __dict__ (no __setattr__), replace() builds a fresh instance so
        # the cache can never go stale; the f-string rebuilt per access
        # was ~13 hits per served decision and ~80 per cfg5 drain key
        return f"{self.namespace}/{self.name}"

    def check_throttled_for(
        self,
        pod: Pod,
        reserved: ResourceAmount,
        is_throttled_on_equal: bool,
        accel_class: Optional[str] = None,
    ) -> str:
        return _check_throttled_for(
            self.spec.threshold,
            self.status,
            pod,
            reserved,
            is_throttled_on_equal,
            step3_on_equal=True,  # throttle_types.go:143
            threshold_override=self.spec.accel_threshold_for(accel_class),
        )

    def with_status(self, status: ThrottleStatus) -> "Throttle":
        return replace(self, status=status)


@dataclass(frozen=True)
class ClusterThrottle:
    """Cluster-scoped CRD (clusterthrottle_types.go:66-72)."""

    name: str
    uid: str = ""
    spec: ClusterThrottleSpec = field(default_factory=ClusterThrottleSpec)
    status: ThrottleStatus = field(default_factory=ThrottleStatus)

    @cached_property
    def key(self) -> str:
        # Go types.NamespacedName{Namespace: "", Name: name}.String() — the
        # leading "/" appears in PreFilter reason strings (plugin.go:289-295).
        # Cached like Throttle.key (frozen-safe — see there).
        return f"/{self.name}"

    def check_throttled_for(
        self,
        pod: Pod,
        reserved: ResourceAmount,
        is_throttled_on_equal: bool,
        accel_class: Optional[str] = None,
    ) -> str:
        return _check_throttled_for(
            self.spec.threshold,
            self.status,
            pod,
            reserved,
            is_throttled_on_equal,
            step3_on_equal=is_throttled_on_equal,  # clusterthrottle_types.go:45
            threshold_override=self.spec.accel_threshold_for(accel_class),
        )

    def with_status(self, status: ThrottleStatus) -> "ClusterThrottle":
        return replace(self, status=status)


def throttle_names(objs: Sequence[Throttle]) -> List[str]:
    return [o.key for o in objs]


def cluster_throttle_names(objs: Sequence[ClusterThrottle]) -> List[str]:
    return [o.key for o in objs]
