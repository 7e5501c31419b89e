"""Minimal Pod / Namespace model.

The reference consumes upstream ``corev1.Pod``; the new framework is
standalone, so this module defines exactly the slice of the pod object the
throttler reads:

- ``metadata``: namespace/name/uid/labels (selector matching, ledger keys);
- ``spec``: schedulerName + nodeName (count-in predicate), container /
  init-container requests + overhead (effective request);
- ``status.phase`` (terminated predicate).

Predicates mirror the reference's pkg/controllers/pod_util.go:
``is_scheduled`` = NodeName != "" (pod_util.go:300-302 per SURVEY);
``is_not_finished`` = phase ∉ {Succeeded, Failed}.

**Gang / heterogeneity annotations.** The gang-admission subsystem
(engine/gang.py, docs/gang_admission.md) reads its PodGroup contract from
pod annotations — the same place kube-batch/volcano-style gang schedulers
put theirs:

- ``kube-throttler.github.io/pod-group``: the group name. All ranks of one
  tightly-coupled job carry the same name; the group key is
  ``namespace/name`` (gangs never span namespaces).
- ``kube-throttler.github.io/pod-group-size``: the expected member count
  (min-available). Admission is all-or-nothing across exactly this many
  ranks; a malformed or non-positive size disables gang handling for the
  pod (it degrades to per-pod admission — a typo must not wedge a pod
  forever behind a group that can never form).
- ``kube-throttler.github.io/accel-class``: the accelerator class the pod
  runs on (e.g. ``tpu-v5e``); selects the per-class effective threshold a
  throttle may declare (api/types.py ``AccelClassThreshold``).
- ``kube-throttler.github.io/priority``: integer admission priority
  (higher admits first). When capacity opens, parked candidates re-enter
  the scheduler's queue in (priority desc, age) order — the
  preemption-ordered admission lane. Malformed values read as 0.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Mapping, Optional, Union

from ..quantity import parse_quantity
from ..resourcelist import ResourceList

GROUP_NAME_ANNOTATION = "kube-throttler.github.io/pod-group"
GROUP_SIZE_ANNOTATION = "kube-throttler.github.io/pod-group-size"
ACCEL_CLASS_ANNOTATION = "kube-throttler.github.io/accel-class"
PRIORITY_ANNOTATION = "kube-throttler.github.io/priority"

_uid_counter = itertools.count(1)


def _gen_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class Container:
    requests: ResourceList = field(default_factory=dict)
    name: str = ""

    @staticmethod
    def of(requests: Mapping[str, Union[str, int, float]], name: str = "") -> "Container":
        return Container(
            requests={k: parse_quantity(v) for k, v in requests.items()}, name=name
        )


@dataclass
class PodSpec:
    scheduler_name: str = ""
    node_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Optional[ResourceList] = None


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed | Unknown


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_gen_uid)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @cached_property
    def key(self) -> str:
        """namespace/name — the NamespacedName string form used everywhere.
        Cached: identity fields never mutate by contract (updates go
        through dataclasses.replace, which builds a fresh instance)."""
        return f"{self.namespace}/{self.name}"

    def is_scheduled(self) -> bool:
        return self.spec.node_name != ""

    def is_not_finished(self) -> bool:
        return self.status.phase not in ("Succeeded", "Failed")


@dataclass(frozen=True)
class PodGroup:
    """The gang contract one pod declares: which group it belongs to and
    how many ranks the group needs before any of them may admit."""

    key: str  # "namespace/name" — gangs never span namespaces
    name: str
    size: int


def pod_group_of(pod: "Pod") -> Optional[PodGroup]:
    """Parse the PodGroup annotations, or None when the pod is not gang-
    scheduled. A malformed or non-positive size also yields None: a typo
    must degrade to per-pod admission, never wedge the pod behind a group
    that can never form."""
    name = pod.annotations.get(GROUP_NAME_ANNOTATION, "")
    if not name:
        return None
    raw = pod.annotations.get(GROUP_SIZE_ANNOTATION, "")
    try:
        size = int(raw)
    except (TypeError, ValueError):
        return None
    if size <= 0:
        return None
    return PodGroup(key=f"{pod.namespace}/{name}", name=name, size=size)


def accel_class_of(pod: "Pod") -> Optional[str]:
    """The pod's accelerator class annotation, or None. Falls back to the
    same-named label (some fleets stamp node-selector-style labels)."""
    return (
        pod.annotations.get(ACCEL_CLASS_ANNOTATION)
        or pod.labels.get(ACCEL_CLASS_ANNOTATION)
        or None
    )


def priority_of(pod: "Pod") -> int:
    """Integer admission priority (higher first); malformed values read
    as 0 so a typo cannot starve or catapult a pod."""
    raw = pod.annotations.get(PRIORITY_ANNOTATION, "")
    if not raw:
        return 0
    try:
        return int(raw)
    except (TypeError, ValueError):
        return 0


@dataclass
class Namespace:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_gen_uid)


def make_pod(
    name: str,
    namespace: str = "default",
    labels: Optional[Dict[str, str]] = None,
    requests: Optional[Mapping[str, Union[str, int, float]]] = None,
    init_requests: Optional[List[Mapping[str, Union[str, int, float]]]] = None,
    overhead: Optional[Mapping[str, Union[str, int, float]]] = None,
    scheduler_name: str = "my-scheduler",
    node_name: str = "",
    phase: str = "Pending",
    annotations: Optional[Dict[str, str]] = None,
    group: Optional[str] = None,
    group_size: Optional[int] = None,
    accel_class: Optional[str] = None,
    priority: Optional[int] = None,
) -> Pod:
    """Test/bench convenience builder (single app container). ``group`` /
    ``group_size`` / ``accel_class`` / ``priority`` are sugar for the gang
    and heterogeneity annotations."""
    containers = [Container.of(requests or {})]
    init_containers = [Container.of(r) for r in (init_requests or [])]
    ann = dict(annotations or {})
    if group is not None:
        ann[GROUP_NAME_ANNOTATION] = group
    if group_size is not None:
        ann[GROUP_SIZE_ANNOTATION] = str(group_size)
    if accel_class is not None:
        ann[ACCEL_CLASS_ANNOTATION] = accel_class
    if priority is not None:
        ann[PRIORITY_ANNOTATION] = str(priority)
    return Pod(
        name=name,
        namespace=namespace,
        labels=dict(labels or {}),
        annotations=ann,
        spec=PodSpec(
            scheduler_name=scheduler_name,
            node_name=node_name,
            containers=containers,
            init_containers=init_containers,
            overhead={k: parse_quantity(v) for k, v in overhead.items()}
            if overhead
            else None,
        ),
        status=PodStatus(phase=phase),
    )
