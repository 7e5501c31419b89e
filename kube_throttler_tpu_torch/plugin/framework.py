"""Minimal scheduling-framework types.

The reference plugs into k8s.io/kubernetes' scheduler framework; the new
framework is standalone, so the tiny surface the plugin actually touches is
defined here: Status codes (framework.NewStatus usage at plugin.go:155,179,
214,234), cluster events for requeue hints (plugin.go:263-279), and the
event-recorder interface (plugin.go:190-201).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ..utils.lockorder import guard_attrs, make_lock
from typing import Dict, List, Optional, Tuple


class StatusCode(Enum):
    SUCCESS = "Success"
    ERROR = "Error"
    UNSCHEDULABLE = "Unschedulable"
    UNSCHEDULABLE_AND_UNRESOLVABLE = "UnschedulableAndUnresolvable"


@dataclass(frozen=True)
class Status:
    code: StatusCode = StatusCode.SUCCESS
    reasons: Tuple[str, ...] = ()

    def is_success(self) -> bool:
        return self.code == StatusCode.SUCCESS

    def is_unschedulable(self) -> bool:
        """Capacity-shaped rejection (either unschedulable code) — the
        rejections gang-aware preemption may resolve; ERROR is not one."""
        return self.code in (
            StatusCode.UNSCHEDULABLE,
            StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE,
        )

    def message(self) -> str:
        return ", ".join(self.reasons)


@dataclass(frozen=True)
class ClusterEvent:
    resource: str
    action_type: str = "All"


@dataclass(frozen=True)
class PodEvent:
    pod_key: str
    event_type: str  # "Warning" | "Normal"
    reason: str
    action: str
    note: str


class EventRecorder:
    def eventf(
        self, pod_key: str, event_type: str, reason: str, action: str, note: str
    ) -> None:  # pragma: no cover — interface
        raise NotImplementedError


@guard_attrs
class RecordingEventRecorder(EventRecorder):
    """Stores emitted events (the integration tier asserts on them the way
    the reference asserts on FailedScheduling / ResourceRequestsExceeds…
    events — util_pod_test.go:68-92).

    Identical events aggregate into one entry with a count (like the real
    kube event recorder's correlator) and distinct entries are capped at
    ``max_events`` with oldest-first eviction — a daemon retrying one stuck
    pod every flush interval must not grow memory without bound."""

    GUARDED_BY = {
        "events": "self._lock",
        "counts": "self._lock",
    }

    def __init__(self, max_events: int = 10_000) -> None:
        self._lock = make_lock("plugin.event_recorder")
        self._max_events = max_events
        self.events: List[PodEvent] = []
        self.counts: Dict[PodEvent, int] = {}

    def eventf(self, pod_key: str, event_type: str, reason: str, action: str, note: str) -> None:
        ev = PodEvent(pod_key, event_type, reason, action, note)
        with self._lock:
            if ev in self.counts:
                self.counts[ev] += 1
                return
            self.counts[ev] = 1
            self.events.append(ev)
            if len(self.events) > self._max_events:
                evicted = self.events.pop(0)
                self.counts.pop(evicted, None)

    def events_for(self, pod_key: str) -> List[PodEvent]:
        with self._lock:
            return [e for e in self.events if e.pod_key == pod_key]
